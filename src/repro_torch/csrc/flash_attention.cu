// Hopper (sm_90a) flash attention: GQA, causal with a query offset, sliding
// window, f32 or bf16 in and out, f32 softmax.
//
//   flash_attention_kernel / flash_attention_f32_kernel  replace the Pallas kernel
//       `_flash_kernel` (repro/kernels/flash_attention/kernel.py, reached
//       through flash_attention).  Same function: query head h reads kv head
//       h / (Hq/Hkv); key k is seen by query q when k <= q_offset + q and,
//       with a window, k > q_offset + q - window; scale hd^-0.5; online
//       softmax with f32 (m, l, acc); the output in q's dtype.
//
// What bounds it on an H100.  Prefill is bound by operations: 4*hd flops per
// visible (query head, query, key) pair, over 989 TFLOP/s of bf16 tensor
// cores (qwen2-0.5b at T = 1024: 1.9 GFLOP, 1.9 us).  Decode (Tq = 1) is
// bound by bytes: the K and V rows up to the query's position over 3.35
// TB/s, under a microsecond even at hd 256 and 2048 keys, so in practice by
// the latency of a launch and of one block's loads.
//
// Design of the bf16 kernel (the model's path):
//   * rows are (query position, query head) pairs of one kv head, packed
//     group-major (row r: position t0 + r / G, head kvh * G + r % G), so a
//     K/V tile is read once for all G heads;
//   * Q.K^T and P.V run on tensor cores, mma.sync m16n8k16 bf16 -> f32, with
//     fragments loaded from shared memory by ldmatrix (V transposed);
//   * two shapes of block, 4 warps each.  Prefill: 4 warps x 16 rows (64
//     rows: 9 positions at G = 7, 4 at G = 16), each warp over the whole key
//     tile.  Decode (G * Tq <= 16): 16 rows, the 4 warps take a quarter of
//     each 64-key tile each and their (m, l, acc) are merged at the end.
//     A warp whose rows all see a whole slice of keys skips the mask;
//   * K and V tiles (64 keys, 32 at hd 256 prefill) move to shared memory
//     by 16-byte cp.async in a two-stage ring, the next tile in flight
//     while the tensor cores work on this one.  Rows past k_end are
//     zero-filled (a masked key's 0 * v stays finite).  16-byte copies need
//     16-byte aligned rows: the wrapper checks the pointers and strides and
//     raises otherwise;
//   * the scores are scaled in f32 after the product (bf16 x bf16 products
//     are exact in f32, so only the order of f32 roundings changes), and
//     the softmax's row max and sum use quad shuffles in the fragment layout;
//   * P keeps f32 precision through P.V: P_hi = bf16(P), P_lo = bf16(P -
//     P_hi), acc += P_hi.V + P_lo.V, two products.  P rounded once to bf16
//     errs by up to 2^-9 relative per weight, which was 34-46x the per
//     element limit in an emulation at prefill 1024; the split errs by about
//     2^-17 and keeps it;
//   * a split key range (flash-decoding) when the grid leaves room on the
//     card: the wrapper's split_plan cuts each row tile's visible key range
//     into chunks of tiles_per_chunk whole tiles, one block each (a row
//     tile with a shorter range uses fewer; the blocks past them exit at
//     once).  Each block writes its (m, l, acc) in f32 to a workspace; the
//     last block of a row tile to finish (an atomic ticket per row tile,
//     reset to 0 by that block so the array is reused) merges the partials
//     in fixed chunk order, float4 at a time with 8 loads in flight per
//     thread, and writes o.  No float atomics: the result is the same bit
//     for bit from run to run.  A row that sees none of a chunk's keys has
//     m = -inf, l = 0 there and weighs 0 in the merge, never -inf - -inf.
//     The merge runs on one SM and grows with the chunks, so split_plan
//     keeps them near sqrt(keys / (2 * rows)) and within one wave;
//   * under grad the caller may ask for each row's log-sum-exp and for o
//     in f32 before its rounding (null pointers otherwise, so serving's
//     bits and launches are the same): K3's backward
//     (flash_attention_bwd.cu) reads both;
//   * each block computes its own key range as before (causal blocks stop
//     at their last query, windowed ones start at their first query's
//     window), and inputs are strided views with a contiguous head dim, so
//     the model passes its (B, T, H, hd) projections and caches uncopied.
// The f32 kernel (tests and the f32 model builds) keeps exact f32 products
// on the SIMT cores (no TF32): 32-key tiles, one key per lane, 32 rows per
// block, no split.  Head dims 16, 32, 64, 128 and 256 are compiled for both.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int hq, hkv, tq, tk;
  long long sq[3], sk[3], sv[3], so[3];   // element strides of b, h, t
  int causal, window, q_offset;
  float scale;
  int qt;                                 // query positions per block
  // bf16 kernel only
  int row_tiles, splits, tiles_per_chunk;
  float* ws;                              // split partials (splits > 1)
  int* tickets;                           // one per row tile, all 0 between launches
  // for the backward, only when a gradient is asked (null in serving): each
  // row's log-sum-exp of its scaled scores (B, Hq, Tq), and o before its
  // rounding to bf16, in f32 with o's strides
  float* lse;
  float* o32;
};

// The keys any row of query positions [t0, t1) can see.
__device__ __forceinline__ void key_range(const Args& a, int t0, int t1, int& k_begin,
                                          int& k_end) {
  k_begin = 0;
  k_end = a.tk;
  if (a.causal) {
    k_end = min(a.tk, a.q_offset + t1);
    if (a.window > 0) k_begin = max(0, a.q_offset + t0 - a.window + 1);
  }
}

__device__ __forceinline__ bool visible(const Args& a, int key, int k_end, int qpos) {
  bool ok = key < k_end;
  if (a.causal) {
    ok = ok && key <= qpos;
    if (a.window > 0) ok = ok && key > qpos - a.window;
  }
  return ok;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 2;
constexpr int MAX_SPLITS = 64;

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) as bf16 pair hi, and the bf16 pair of what rounding left, lo
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// Compile-time shape of one bf16 variant: ROWS rows (16 x row warps), KW
// warps sharing each key tile, BK keys per tile.
template <int HD, int ROWS, int KW, int BK>
struct Shape {
  static constexpr int RW = ROWS / 16;
  static constexpr int KPW = BK / KW;          // keys of a tile per warp
  static constexpr int NT = KPW / 8;           // score n-tiles per warp
  static constexpr int DT = HD / 8;            // output n-tiles per warp
  static constexpr int LD = HD + 8;            // smem row stride (bf16): 16 B pad, no bank conflicts
  static constexpr int CH = HD / 8;            // 16-byte chunks per row
  static constexpr int Q_BYTES = ROWS * LD * 2;
  static constexpr int TILE_BYTES = BK * LD * 2;
  static constexpr int LOOP_BYTES = Q_BYTES + 2 * STAGES * TILE_BYTES;
  // after the loop: per-warp partials (m, l, acc) and the merge weights
  static constexpr int PARTS = KW * ROWS;
  static constexpr int MERGE_BYTES = 4 * (PARTS * (HD + 2) + ROWS * (MAX_SPLITS + 2));
  static constexpr int SMEM = LOOP_BYTES > MERGE_BYTES ? LOOP_BYTES : MERGE_BYTES;
  static_assert(RW * KW == WARPS, "4 warps per block");
  static_assert(KPW % 16 == 0 && HD % 16 == 0, "whole m16n8k16 steps");
};

template <int HD, int BK>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst_k, __nv_bfloat16* dst_v,
                                          const __nv_bfloat16* kp, const __nv_bfloat16* vp,
                                          long long sk, long long sv, int kt0, int k_end) {
  constexpr int CH = HD / 8, LD = HD + 8;
#pragma unroll
  for (int c = threadIdx.x; c < BK * CH; c += THREADS) {
    const int row = c / CH, col = (c % CH) * 8;
    const int key = kt0 + row;
    const bool ok = key < k_end;
    cp_async16(smem_u32(dst_k + row * LD + col), ok ? kp + key * sk + col : kp, ok ? 16 : 0);
    cp_async16(smem_u32(dst_v + row * LD + col), ok ? vp + key * sv + col : vp, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void axpy4(float4& x, float w, const float4& y) {
  x.x = fmaf(w, y.x, x.x);
  x.y = fmaf(w, y.y, x.y);
  x.z = fmaf(w, y.z, x.z);
  x.w = fmaf(w, y.w, x.w);
}

// o[t, h, d .. d + 3] = x / l for block row r (position t0 + r / G, head
// kvh * G + r % G); the same f32 values into o32 when it is not null
__device__ __forceinline__ void store4(__nv_bfloat16* o, float* o32, const Args& a, int t0,
                                       int kvh, int group, int r, int d, float4 x, float l) {
  const float den = fmaxf(l, 1e-37f);
  const int t = t0 + r / group, h = kvh * group + r % group;
  const float4 y = make_float4(x.x / den, x.y / den, x.z / den, x.w / den);
  const long long off = h * a.so[1] + t * a.so[2] + d;
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(o + off);
  dst[0] = __floats2bfloat162_rn(y.x, y.y);
  dst[1] = __floats2bfloat162_rn(y.z, y.w);
  if (o32 != nullptr) *reinterpret_cast<float4*>(o32 + off) = y;
}

// each row's log-sum-exp m + log l (+inf for a row that saw no key, whose
// weights the backward then takes as 0), when the caller asked for it
__device__ __forceinline__ void store_lse(const Args& a, int b, int t0, int kvh, int group,
                                          int r, float m, float l) {
  const int t = t0 + r / group, h = kvh * group + r % group;
  a.lse[((long long)b * a.hq + h) * a.tq + t] = l > 0.f ? m + logf(l) : INFINITY;
}

// Grid: (row_tiles * splits, hkv, batch); block x = row tile * splits + split.
// The launch bounds name a minimum of one block per SM: given the thread
// count alone, ptxas held the 16-row variants at hd 32 and 64 to 96
// registers and spilled; with it they take 125-127 and spill nothing.
template <int HD, int ROWS, int KW, int BK>
__global__ void __launch_bounds__(THREADS, 1) flash_attention_kernel(Args a) {
  using S = Shape<HD, ROWS, KW, BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + S::Q_BYTES);
  __nv_bfloat16* v_s = k_s + STAGES * BK * S::LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp / KW, kw = warp % KW;
  const int g = lane / 4, c = lane % 4;
  const int group = a.hq / a.hkv;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int rt = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  const int t0 = rt * a.qt, t1 = min(a.tq, t0 + a.qt);
  const int valid_rows = (t1 - t0) * group;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.sq[0];
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.so[0];
  float* o32 = a.o32 != nullptr ? a.o32 + b * a.so[0] : nullptr;

  int k_begin, k_end;
  key_range(a, t0, t1, k_begin, k_end);
  // this row tile's chunks: whole tiles, tiles_per_chunk each; blocks past
  // the last chunk of a shorter row tile have nothing to do
  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int nsplit = ntiles > 0 ? (ntiles + a.tiles_per_chunk - 1) / a.tiles_per_chunk : 1;
  if (split >= nsplit) return;
  const int tile_lo = split * a.tiles_per_chunk;
  const int n = min(ntiles, tile_lo + a.tiles_per_chunk) - tile_lo;

  // this thread's two rows, r0 and r0 + 8, and their query positions; the
  // first and last position of the warp's 16 rows
  const int r0 = rw * 16 + g;
  const int qpos0 = a.q_offset + t0 + r0 / group;
  const int qpos1 = a.q_offset + t0 + (r0 + 8) / group;
  const int wq_lo = a.q_offset + t0 + rw * 16 / group;
  const int wq_hi = a.q_offset + t0 + (rw * 16 + 15) / group;

  if (n > 0) {
    for (int e = tid; e < ROWS * S::CH; e += THREADS) {
      const int r = e / S::CH, col = (e % S::CH) * 8;
      const int t = t0 + r / group, h = kvh * group + r % group;
      const bool ok = r < valid_rows;
      cp_async16(smem_u32(q_s + r * S::LD + col), ok ? q + h * a.sq[1] + t * a.sq[2] + col : q,
                 ok ? 16 : 0);
    }
    load_tile<HD, BK>(k_s, v_s, kp, vp, a.sk[2], a.sv[2], k_begin + tile_lo * BK, k_end);
  }
  cp_async_commit();

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[S::DT][4];
#pragma unroll
  for (int j = 0; j < S::DT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int i = 0; i < n; ++i) {
    const int stage = i % STAGES;
    if (i + 1 < n) {
      const int nxt = (i + 1) % STAGES;
      load_tile<HD, BK>(k_s + nxt * BK * S::LD, v_s + nxt * BK * S::LD, kp, vp, a.sk[2],
                        a.sv[2], k_begin + (tile_lo + i + 1) * BK, k_end);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* kt = k_s + stage * BK * S::LD + kw * S::KPW * S::LD;
    const __nv_bfloat16* vt = v_s + stage * BK * S::LD + kw * S::KPW * S::LD;
    const int key0 = k_begin + (tile_lo + i) * BK + kw * S::KPW;

    // S = Q . K^T over this warp's 16 rows and KPW keys
    float s[S::NT][4];
#pragma unroll
    for (int j = 0; j < S::NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t qa[4];
      ldmatrix_x4(qa, smem_u32(q_s + (rw * 16 + lane % 16) * S::LD + kk * 16 + (lane / 16) * 8));
#pragma unroll
      for (int np = 0; np < S::NT / 2; ++np) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(kt + (np * 16 + (lane / 16) * 8 + lane % 8) * S::LD +
                                 kk * 16 + ((lane / 8) % 2) * 8));
        mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
      }
    }

    // scale, mask, online softmax in f32 (rows r0: s[j][0..1], r0 + 8:
    // s[j][2..3]); a slice every row of the warp sees in full skips the mask
    const bool seen = key0 + S::KPW <= k_end &&
                      (!a.causal || (key0 + S::KPW - 1 <= wq_lo &&
                                     (a.window <= 0 || key0 > wq_hi - a.window)));
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < S::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + j * 8 + 2 * c + e;
        s[j][e] = seen || visible(a, key, k_end, qpos0) ? s[j][e] * a.scale : -INFINITY;
        s[j][2 + e] =
            seen || visible(a, key, k_end, qpos1) ? s[j][2 + e] * a.scale : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;   // no visible key yet: p = 0
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    const float alpha0 = expf(m0 - mu0), alpha1 = expf(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < S::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(s[j][e] - mu0);
        s[j][2 + e] = expf(s[j][2 + e] - mu1);
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
#pragma unroll
    for (int j = 0; j < S::DT; ++j) {
      acc[j][0] *= alpha0;
      acc[j][1] *= alpha0;
      acc[j][2] *= alpha1;
      acc[j][3] *= alpha1;
    }

    // acc += P_hi . V + P_lo . V, 16 keys per step (the score fragments of
    // two n-tiles are the A fragment of one step)
#pragma unroll
    for (int ks = 0; ks < S::KPW / 16; ++ks) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * ks][0], s[2 * ks][1], ph[0], pl[0]);
      split_bf16(s[2 * ks][2], s[2 * ks][3], ph[1], pl[1]);
      split_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(vt + (ks * 16 + ((lane / 8) % 2) * 8 + lane % 8) * S::LD +
                                       dp * 16 + (lane / 16) * 8));
        mma_bf16(acc[2 * dp], ph, vb[0], vb[1]);
        mma_bf16(acc[2 * dp], pl, vb[0], vb[1]);
        mma_bf16(acc[2 * dp + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[2 * dp + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();     // shared memory is reused below
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // each warp's partial: part p = kw * ROWS + r
  float* part_m = reinterpret_cast<float*>(smem);
  float* part_l = part_m + S::PARTS;
  float* part_acc = part_l + S::PARTS;
  float* wgt = part_acc + S::PARTS * HD;       // [ROWS][<= MAX_SPLITS]
  float* row_m = wgt + ROWS * MAX_SPLITS;
  float* row_l = row_m + ROWS;
  const int p0 = kw * ROWS + r0;
  if (c == 0) {
    part_m[p0] = m0;
    part_l[p0] = l0;
    part_m[p0 + 8] = m1;
    part_l[p0 + 8] = l1;
  }
#pragma unroll
  for (int j = 0; j < S::DT; ++j) {
    const int d = j * 8 + 2 * c;
    part_acc[p0 * HD + d] = acc[j][0];
    part_acc[p0 * HD + d + 1] = acc[j][1];
    part_acc[(p0 + 8) * HD + d] = acc[j][2];
    part_acc[(p0 + 8) * HD + d + 1] = acc[j][3];
  }
  __syncthreads();

  // merge the KW warps' partials of each row, in fixed warp order
  if (tid < ROWS) {
    float mx = -INFINITY;
    for (int w = 0; w < KW; ++w) mx = fmaxf(mx, part_m[w * ROWS + tid]);
    float lsum = 0.f;
    for (int w = 0; w < KW; ++w) {
      const float mw = part_m[w * ROWS + tid];
      const float wt = mw == -INFINITY ? 0.f : expf(mw - mx);
      wgt[tid * KW + w] = wt;
      lsum += wt * part_l[w * ROWS + tid];
    }
    row_m[tid] = mx;
    row_l[tid] = lsum;
  }
  __syncthreads();

  // the block's rows, 4 dims at a time: e = r * V4 + d / 4
  constexpr int V4 = HD / 4;
  const int n4 = valid_rows * V4;
  const float4* part4 = reinterpret_cast<const float4*>(part_acc);
  if (nsplit == 1) {
    for (int e = tid; e < n4; e += THREADS) {
      const int r = e / V4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < KW; ++w) axpy4(x, wgt[r * KW + w], part4[w * ROWS * V4 + e]);
      store4(o, o32, a, t0, kvh, group, r, (e % V4) * 4, x, row_l[r]);
    }
    if (a.lse != nullptr && tid < valid_rows)
      store_lse(a, b, t0, kvh, group, tid, row_m[tid], row_l[tid]);
    return;
  }

  // split: publish this block's partial, then the last block of the row
  // tile to finish merges all of them
  const int slot = (b * a.hkv + kvh) * a.row_tiles + rt;
  const long long nparts = (long long)gridDim.z * a.hkv * a.row_tiles * a.splits * ROWS;
  float* ws_m = a.ws;
  float* ws_l = ws_m + nparts;
  float4* ws4 = reinterpret_cast<float4*>(ws_l + nparts);
  const long long first = (long long)slot * a.splits * ROWS;   // this row tile's split 0
  const long long mine = first + (long long)split * ROWS;
  if (tid < ROWS) {
    ws_m[mine + tid] = row_m[tid];
    ws_l[mine + tid] = row_l[tid];
  }
  for (int e = tid; e < n4; e += THREADS) {
    const int r = e / V4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < KW; ++w) axpy4(x, wgt[r * KW + w], part4[w * ROWS * V4 + e]);
    ws4[mine * V4 + e] = x;
  }
  __threadfence();
  __syncthreads();
  __shared__ int is_last;
  if (tid == 0) is_last = atomicAdd(&a.tickets[slot], 1) == nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  if (tid < ROWS) {
    float mx = -INFINITY;
    for (int sp = 0; sp < nsplit; ++sp) mx = fmaxf(mx, __ldcg(ws_m + first + sp * ROWS + tid));
    float lsum = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float ms = __ldcg(ws_m + first + sp * ROWS + tid);
      const float wt = ms == -INFINITY ? 0.f : expf(ms - mx);   // a row that saw no key: 0
      wgt[tid * nsplit + sp] = wt;
      lsum += wt * __ldcg(ws_l + first + sp * ROWS + tid);
    }
    row_l[tid] = lsum;
    if (a.lse != nullptr && tid < valid_rows) store_lse(a, b, t0, kvh, group, tid, mx, lsum);
  }
  __syncthreads();
  // U independent loads in flight per thread and split, summed in split order
  constexpr int U = 8;
  for (int e0 = tid; e0 < n4; e0 += THREADS * U) {
    float4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < nsplit; ++sp) {
      const float4* src = ws4 + (first + (long long)sp * ROWS) * V4;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * THREADS;
        if (e < n4) axpy4(x[u], wgt[(e / V4) * nsplit + sp], __ldcg(src + e));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * THREADS;
      if (e < n4) store4(o, o32, a, t0, kvh, group, e / V4, (e % V4) * 4, x[u], row_l[e / V4]);
    }
  }
  if (tid == 0) a.tickets[slot] = 0;   // ready for the next launch
}

// What one bf16 variant is: its key tile, its dynamic shared memory, and how
// many of its blocks one SM of the current device holds at once.
struct Variant {
  int bk = 0, smem = 0, per_sm = 0;
};

// Launch the variant (v null; bk must be its key tile) or describe it in v.
template <int HD, int ROWS, int KW, int BK>
cudaError_t run_bf16(const Args* a, int bk, dim3 grid, cudaStream_t stream, Variant* v) {
  constexpr int bytes = Shape<HD, ROWS, KW, BK>::SMEM;
  auto kernel = flash_attention_kernel<HD, ROWS, KW, BK>;
  if (bytes > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  if (v) {
    v->bk = BK;
    v->smem = bytes;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&v->per_sm, kernel, THREADS, bytes);
  }
  if (bk != BK) return cudaErrorInvalidValue;
  kernel<<<grid, THREADS, bytes, stream>>>(*a);
  return cudaGetLastError();
}

// The bf16 variants: decode (16 rows, 4 warps on each 64-key tile) and
// prefill (64 rows, 64-key tiles, 32 at hd 256).
template <int HD>
cudaError_t variant_bf16(int rows, const Args* a, int bk, dim3 grid, cudaStream_t stream,
                         Variant* v) {
  constexpr int PBK = HD > 128 ? 32 : 64;
  if (rows == 16) return run_bf16<HD, 16, 4, 64>(a, bk, grid, stream, v);
  if (rows == 64) return run_bf16<HD, 64, 1, PBK>(a, bk, grid, stream, v);
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_bf16(int hd, int rows, const Args* a, int bk, dim3 grid,
                          cudaStream_t stream, Variant* v) {
  switch (hd) {
    case 16: return variant_bf16<16>(rows, a, bk, grid, stream, v);
    case 32: return variant_bf16<32>(rows, a, bk, grid, stream, v);
    case 64: return variant_bf16<64>(rows, a, bk, grid, stream, v);
    case 128: return variant_bf16<128>(rows, a, bk, grid, stream, v);
    case 256: return variant_bf16<256>(rows, a, bk, grid, stream, v);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32: exact f32 products on the SIMT cores
// ---------------------------------------------------------------------------

constexpr int F_WARPS = 8;
constexpr int F_THREADS = F_WARPS * 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int MAX_ROWS = F_WARPS * ROWS_PER_WARP;   // (head, position) rows a block owns
constexpr int F_BK = 32;                            // keys per tile, one per lane

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

template <int HD>
constexpr int f32_smem_floats() {
  return MAX_ROWS * HD + F_BK * (HD + 4) + F_BK * HD;
}

// Load keys kt0 .. kt0 + F_BK - 1 of K and V into registers, zero past k_end.
template <int HD, int N>
__device__ __forceinline__ void fetch_tile(const float* kp, const float* vp, long long sk,
                                           long long sv, int kt0, int k_end,
                                           float (&kreg)[N], float (&vreg)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = threadIdx.x + i * F_THREADS;
    const int key = kt0 + e / HD, d = e % HD;
    const bool in = key < k_end;
    kreg[i] = in ? __ldg(kp + key * sk + d) : 0.f;
    vreg[i] = in ? __ldg(vp + key * sv + d) : 0.f;
  }
}

// Grid: (ceil(tq / qt), hkv, batch).  Row r of a block is query position
// t0 + r / G of query head kvh * G + r % G.  A lane scores its key of the
// 32-key tile against a row, the warp reduces max and sum with shuffles,
// and each lane accumulates its own output dims from the V tile.
template <int HD>
__global__ void __launch_bounds__(F_THREADS) flash_attention_f32_kernel(Args a) {
  constexpr int KS = HD + 4;                        // padded K row (floats)
  constexpr int DPL = (HD + 31) / 32;               // output dims per lane
  constexpr int PER_THREAD = F_BK * HD / F_THREADS; // K (and V) tile elements per thread
  static_assert(F_BK * HD % F_THREADS == 0, "tile must split evenly over the block");

  extern __shared__ __align__(16) float fsmem[];
  float* q_s = fsmem;                  // [MAX_ROWS][HD], pre-scaled
  float* k_s = q_s + MAX_ROWS * HD;    // [F_BK][KS]
  float* v_s = k_s + F_BK * KS;        // [F_BK][HD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = a.hq / a.hkv;
  const int rows = group * a.qt;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int t0 = blockIdx.x * a.qt;
  const int t1 = min(a.tq, t0 + a.qt);

  const float* q = static_cast<const float*>(a.q) + b * a.sq[0];
  const float* kp = static_cast<const float*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const float* vp = static_cast<const float*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  float* o = static_cast<float*>(a.o) + b * a.so[0];

  int k_begin, k_end;
  key_range(a, t0, t1, k_begin, k_end);

  for (int e = threadIdx.x; e < MAX_ROWS * HD; e += F_THREADS) {
    const int r = e / HD, d = e % HD;
    const int t = t0 + r / group, h = kvh * group + r % group;
    float x = 0.f;
    if (r < rows && t < t1) x = __ldg(q + h * a.sq[1] + t * a.sq[2] + d) * a.scale;
    q_s[e] = x;
  }

  float m[ROWS_PER_WARP], l[ROWS_PER_WARP], acc[ROWS_PER_WARP][DPL];
#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const int ntiles = k_end > k_begin ? (k_end - k_begin + F_BK - 1) / F_BK : 0;
  float kreg[PER_THREAD], vreg[PER_THREAD];
  if (ntiles > 0) fetch_tile<HD>(kp, vp, a.sk[2], a.sv[2], k_begin, k_end, kreg, vreg);

  for (int tile = 0; tile < ntiles; ++tile) {
    __syncthreads();   // every warp is done with the previous tile (and q_s is written)
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = threadIdx.x + i * F_THREADS;
      const int j = e / HD, d = e % HD;
      k_s[j * KS + d] = kreg[i];
      v_s[j * HD + d] = vreg[i];
    }
    __syncthreads();
    if (tile + 1 < ntiles)   // in flight while this tile is computed
      fetch_tile<HD>(kp, vp, a.sk[2], a.sv[2], k_begin + (tile + 1) * F_BK, k_end, kreg,
                     vreg);

    const int kt0 = k_begin + tile * F_BK;
    const int key = kt0 + lane;
    const int nvalid = min(F_BK, k_end - kt0);
    const float4* krow = reinterpret_cast<const float4*>(k_s + lane * KS);
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp + rr * F_WARPS;            // warp-uniform from here on
      if (r >= rows) break;
      const int t = t0 + r / group;
      if (t >= t1) continue;
      const bool ok = visible(a, key, k_end, a.q_offset + t);
      const float4* qrow = reinterpret_cast<const float4*>(q_s + r * HD);
      float s = 0.f;
#pragma unroll
      for (int d4 = 0; d4 < HD / 4; ++d4) {
        const float4 x = qrow[d4], y = krow[d4];
        s = fmaf(x.x, y.x, s);
        s = fmaf(x.y, y.y, s);
        s = fmaf(x.z, y.z, s);
        s = fmaf(x.w, y.w, s);
      }
      s = ok ? s : -INFINITY;
      const float m_new = fmaxf(m[rr], warp_max(s));
      if (m_new == -INFINITY) continue;           // no visible key for this row yet
      const float p = ok ? expf(s - m_new) : 0.f;
      const float alpha = expf(m[rr] - m_new);    // 0 while m was -inf
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] *= alpha;
      for (int j = 0; j < nvalid; ++j) {
        const float pj = __shfl_sync(FULL, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < HD) acc[rr][i] = fmaf(pj, v_s[j * HD + d], acc[rr][i]);
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
    const int r = warp + rr * F_WARPS;
    if (r >= rows) break;
    const int t = t0 + r / group;
    if (t >= t1) continue;
    const int h = kvh * group + r % group;
    float* orow = o + h * a.so[1] + t * a.so[2];
    const float denom = fmaxf(l[rr], 1e-37f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) orow[d] = acc[rr][i] / denom;
    }
  }
}

template <int HD>
cudaError_t launch_f32(const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr size_t bytes = f32_smem_floats<HD>() * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  flash_attention_f32_kernel<HD><<<grid, F_THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(int hd, const Args& a, dim3 grid, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_f32<16>(a, grid, stream);
    case 32: return launch_f32<32>(a, grid, stream);
    case 64: return launch_f32<64>(a, grid, stream);
    case 128: return launch_f32<128>(a, grid, stream);
    case 256: return launch_f32<256>(a, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, void* o, int hq, int hkv,
               int tq, int tk, const long long* strides, int causal, int window,
               int q_offset, float scale, int qt) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.hq = hq; a.hkv = hkv; a.tq = tq; a.tk = tk;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  a.causal = causal; a.window = window; a.q_offset = q_offset;
  a.scale = scale; a.qt = qt;
  a.row_tiles = (tq + qt - 1) / qt;
  a.splits = 1;
  a.tiles_per_chunk = 1 << 30;
  return a;
}

}  // namespace

extern "C" {

// float32.  strides: 12 element strides, (b, h, t) of q, k, v and o in that
// order; the head dim is contiguous in all four.  Rows a block owns:
// qt * (hq / hkv) <= 32.  Returns the launch's cudaError_t.
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           int batch, int hq, int hkv, int tq, int tk, int hd,
                           const long long* strides, int causal, int window,
                           int q_offset, float scale, int qt, void* stream) {
  if (batch <= 0 || tq <= 0 || hkv <= 0 || hq % hkv || qt <= 0 ||
      qt * (hq / hkv) > MAX_ROWS || batch > 65535 || hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(q, k, v, o, hq, hkv, tq, tk, strides, causal, window, q_offset,
                           scale, qt);
  dim3 grid(a.row_tiles, hkv, batch);
  return (int)dispatch_f32(hd, a, grid, static_cast<cudaStream_t>(stream));
}

// bfloat16, on tensor cores.  As above, plus the plan of split_plan
// (kernel.py): rows (16 or 64) and bk, the key tile, must name a compiled
// variant; qt * (hq / hkv) <= rows query rows per block; each row tile's
// key range is cut into `splits` chunks of `tiles_per_chunk` tiles.  With
// splits > 1, ws holds (2 + hd) * batch * hkv * row_tiles * splits * rows
// floats and tickets batch * hkv * row_tiles zeros (left zero).  All rows of
// q, k and v start 16-byte aligned.  lse (batch * hq * tq floats) and o32
// (f32, o's strides, 16-byte aligned) are null unless the backward will
// need them; they change none of o's bits.
int flash_attention_bf16_launch(const void* q, const void* k, const void* v, void* o,
                                int batch, int hq, int hkv, int tq, int tk, int hd,
                                const long long* strides, int causal, int window,
                                int q_offset, float scale, int rows, int bk, int qt,
                                int splits, int tiles_per_chunk, float* ws, int* tickets,
                                float* lse, float* o32, void* stream) {
  if (batch <= 0 || tq <= 0 || hkv <= 0 || hq % hkv || qt <= 0 ||
      qt * (hq / hkv) > rows || batch > 65535 || hkv > 65535 || splits <= 0 ||
      splits > MAX_SPLITS || tiles_per_chunk <= 0 ||
      (splits > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a = make_args(q, k, v, o, hq, hkv, tq, tk, strides, causal, window, q_offset, scale,
                     qt);
  a.splits = splits;
  a.tiles_per_chunk = tiles_per_chunk;
  a.ws = ws;
  a.tickets = tickets;
  a.lse = lse;
  a.o32 = o32;
  dim3 grid(a.row_tiles * splits, hkv, batch);
  return (int)dispatch_bf16(hd, rows, &a, bk, grid, static_cast<cudaStream_t>(stream),
                            nullptr);
}

// Blocks of the bf16 variant (rows, hd) one SM of the current device holds
// at once, or -1 if it is not compiled.
int flash_attention_blocks_per_sm(int rows, int hd) {
  Variant var;
  return dispatch_bf16(hd, rows, nullptr, 0, dim3(), nullptr, &var) == cudaSuccess
             ? var.per_sm
             : -1;
}

// Dynamic shared memory one block uses (ptxas reports only static shared
// memory): dtype 0 float32, 1 bfloat16 with `rows` rows; -1 if not compiled.
int flash_attention_smem_bytes(int dtype, int rows, int hd) {
  if (dtype == 1) {
    Variant var;
    return dispatch_bf16(hd, rows, nullptr, 0, dim3(), nullptr, &var) == cudaSuccess
               ? var.smem
               : -1;
  }
  switch (hd) {
    case 16: return f32_smem_floats<16>() * (int)sizeof(float);
    case 32: return f32_smem_floats<32>() * (int)sizeof(float);
    case 64: return f32_smem_floats<64>() * (int)sizeof(float);
    case 128: return f32_smem_floats<128>() * (int)sizeof(float);
    case 256: return f32_smem_floats<256>() * (int)sizeof(float);
    default: return -1;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
