// Hopper (sm_90a) kernels for the RWKV-6 WKV recurrence, per (batch, head):
//
//   o_t = (S + diag(u) k_t v_tᵀ)ᵀ r_t,    S ← diag(w_t) S + k_t v_tᵀ,
//
// from a given initial state S0 (zero when none is passed), returning every
// o_t and the final state.
//
//   wkv6_kernel, wkv6_carry_kernel and wkv6_fix_kernel together replace the
//                Pallas kernel `_wkv_kernel` (repro/kernels/rwkv6/kernel.py,
//                reached through wkv6_pallas).  Same function, plus a
//                carried-in state: r, k, v in f32 or bf16 (the model hands
//                over bf16-rounded values), w, u, the state and o in f32,
//                f32 arithmetic on CUDA cores throughout.
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
// Design: a time-chunked scan.  The TPU kernel carries the hd x hd state in
// VMEM across a sequential grid axis over time.  One thread walking all of
// time leaves the card empty (80 warps at rwkv6-3b's B 1) and serial, so
// time is cut into chunks of C steps (the wrapper's TIME_CHUNK), chunk c
// starting at step t_c with the state S_c carried in:
//
//   1. wkv6_kernel, in parallel over (b·h, chunk, 32-column tile): each
//      chunk runs the recurrence from a zero state over its steps, giving
//      local outputs ô_t, its local end state Ŝ_c, its decay product
//      Δ_c = Π w_τ and q_t = r_t ⊙ D_t, D_t = Π_{τ = t_c}^{t-1} w_τ.
//      Reading r, k and w from shared memory once per state element and
//      step (one column a thread) costs 12 B an element, more than shared
//      memory delivers beside 3 f32 operations, so a thread holds 4 rows x
//      4 columns of the state (128 threads a block at hd 64), reads its
//      rows of r, k, w and its columns of v once per step (4 float4 for 16
//      elements, 4 B an element) and does 3 f32 operations per element: the
//      state update (a multiply and a multiply-add) and o's multiply-add.
//      Every 4 steps one reduce-scatter over the 16 row groups (15
//      shuffles) leaves each thread one (step, column) of o.  The bonus
//      term is v_j Σ_i r_i u_i k_i, one sum per step and head, taken from
//      the loaded vectors.  r, k, w, v of a run of TS steps come 16 bytes a
//      load, the next run's loads in flight while the block walks this one.
//   2. wkv6_carry_kernel, sequential over chunks and in parallel over
//      (b·h, i, j): S_{c+1} = diag(Δ_c) S_c + Ŝ_c, with S_0 = S0 or zero.
//      Each chunk's slot of the scratch swaps Ŝ_c for S_c; the last state
//      goes to the output state.
//   3. wkv6_fix_kernel, in parallel over (b·h, 32-step tile):
//      o_t = ô_t + S_cᵀ q_t, a (steps x hd)·(hd x hd) f32 product with S_c
//      and q in shared memory (cp.async), 4 x 8 outputs a thread.
//   Phases 2 and 3 are programmatic dependent launches (Hopper's
//   griddepcontrol): each starts while the phase before it drains and waits
//   for its results in-kernel, so its launch overlaps that phase's tail.
//
// The sum is exact: S_{t-1} = diag(D_t) S_c + Ŝ_{t-1}.  Decays are only
// multiplied, never divided, so nothing overflows; a product that
// underflows to 0 is the true value's rounding.  No tensor cores: TF32 or
// bf16 products would not hold 1e-5 of the largest |o|.
//
// A call with T ≤ C is one launch of phase 1 alone, from S0 and into the
// output state, with no scratch: decode steps are most of the calls, and
// each extra launch costs host time; a longer call is three launches and
// B·H·(nc·(hd² + hd) + T·hd) f32 of scratch (nc = ceil(T / C)), allocated
// by the wrapper.  At rwkv6-3b's prefill 1024 and C = 128 that is 5.2 MB of
// local states (written by phase 1, read and rewritten by phase 2, read by
// phase 3) and 10.5 MB of q (written by phase 1, read by phase 3); with
// the local outputs' second pass, about 63 MB of traffic beside the
// 38.0 MB the bound counts, much of it in the 50 MB L2.
//
// The state is read once and written once; S0 and the output state may be
// the same tensor (the model updates its cache in place): in one launch each
// thread reads its own elements before it writes them, and in three only
// phase 2 touches either, each thread its own elements.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TS = 16;    // phase 1: time steps staged in shared memory per run
constexpr int TQ = 32;    // phase 3: time steps per block (divides every chunk)

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;    // (H, hd)
  const float* s0;   // (B, H, hd, hd) or null (zero state)
  float* o;          // (B, T, H, hd)
  float* st;         // (B, H, hd, hd), may equal s0
  float* scr;        // (B·H, nc, hd, hd) local states, null for one chunk
  float* delta;      // (B·H, nc, hd) chunk decay products, null for one chunk
  float* q;          // (B, T, H, hd) r_t ⊙ D_t, null for one chunk
  int t, h, chunk, nc;
};

// Programmatic dependent launch (Hopper): phases 2 and 3 are launched
// while the phase before them finishes, and wait here for its results.
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void let_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

__device__ __forceinline__ float comp(const float4& v, int x) {
  return x == 0 ? v.x : x == 1 ? v.y : x == 2 ? v.z : v.w;
}

// The E floats of a 16-byte vector of T.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(&raw);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  } else {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 g = __bfloat1622float2(p[x]);
      f[2 * x] = g.x;
      f[2 * x + 1] = g.y;
    }
  }
}

// One run of TS steps of W consecutive columns of a (B, T, H, hd) tensor at
// one (b, h), loaded 16 bytes at a time with every load of the run in flight at once, then
// stored to shared memory as f32.  Rows past the run's n steps are zero.
template <typename T, int W, int THREADS>
struct Run {
  static constexpr int E = 16 / sizeof(T);                 // elements per vector
  static constexpr int VPR = W / E;                        // vectors per step
  static constexpr int N = (TS * VPR + THREADS - 1) / THREADS;
  static_assert(W % E == 0, "a step is whole 16-byte vectors");
  uint4 raw[N];

  // x + first: element (b, t0, h, first column); stride: elements between steps
  __device__ __forceinline__ void load(const T* x, long long first, long long stride,
                                       int n, int tid) {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const int vi = tid + m * THREADS, step = vi / VPR;
      raw[m] = vi < TS * VPR && step < n
          ? __ldg(reinterpret_cast<const uint4*>(x + first + step * stride) + vi % VPR)
          : make_uint4(0, 0, 0, 0);
    }
  }

  // into dst[TS][W]
  __device__ __forceinline__ void store(float* dst, int tid) const {
#pragma unroll
    for (int m = 0; m < N; ++m) {
      const int vi = tid + m * THREADS;
      if (vi >= TS * VPR) continue;
      float f[E];
      unpack<T>(raw[m], f);
      float4* d = reinterpret_cast<float4*>(dst + (vi / VPR) * W + (vi % VPR) * E);
#pragma unroll
      for (int x = 0; x < E / 4; ++x)
        d[x] = make_float4(f[4 * x], f[4 * x + 1], f[4 * x + 2], f[4 * x + 3]);
    }
  }
};

// Phase 1's thread layout at head width HD: a block takes COLS of the
// state's columns, RG row groups x COLS / J column groups.  A thread holds
// 4 rows x J columns of the state, and the o partial sums of P steps x J
// columns go through one reduce-scatter over the RG row groups (P J = RG
// values, one left a thread).
template <int HD>
struct Local {
  static constexpr int RG = HD / 4;                      // row groups
  static constexpr int COLS = HD < 32 ? HD : 32;         // columns per block
  static constexpr int J = RG < 4 ? RG : 4;              // columns per thread
  static constexpr int P = RG / J;                       // steps per reduce-scatter
  static constexpr int THREADS = RG * (COLS / J);
  static constexpr unsigned MASK = THREADS < 32 ? (1u << THREADS) - 1 : 0xffffffffu;
  static_assert(P * J == RG && TS % P == 0, "one value a thread after the reduce-scatter");
};

// J consecutive floats at p (16-byte aligned when J is a multiple of 4).
template <int J>
__device__ __forceinline__ void load_row(const float* p, float* dst) {
  if constexpr (J % 4 == 0) {
#pragma unroll
    for (int x = 0; x < J; x += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + x);
      dst[x] = v.x; dst[x + 1] = v.y; dst[x + 2] = v.z; dst[x + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int x = 0; x < J; ++x) dst[x] = p[x];
  }
}

template <int J>
__device__ __forceinline__ void store_row(float* p, const float* src) {
  if constexpr (J % 4 == 0) {
#pragma unroll
    for (int x = 0; x < J; x += 4)
      *reinterpret_cast<float4*>(p + x) = make_float4(src[x], src[x + 1], src[x + 2], src[x + 3]);
  } else {
#pragma unroll
    for (int x = 0; x < J; ++x) p[x] = src[x];
  }
}

// Reduce-scatter of V = 2 LVL values over 2 LVL threads (bits of g): at each
// level a thread keeps the half of its values its bit selects and adds its
// partner's, so thread g is left with the sum of value g in part[0].
template <int LVL, unsigned MASK, int V>
__device__ __forceinline__ void reduce_scatter(float (&part)[V], int g) {
  if constexpr (LVL >= 1) {
    const bool upper = g & LVL;
#pragma unroll
    for (int x = 0; x < LVL; ++x) {
      const float keep = upper ? part[x + LVL] : part[x];
      const float send = upper ? part[x] : part[x + LVL];
      part[x] = keep + __shfl_xor_sync(MASK, send, LVL);
    }
    reduce_scatter<LVL / 2, MASK>(part, g);
  }
}

// Phase 1.  Grid (B·H, nc, HD / COLS): one block per (batch, head, chunk,
// column tile).  Thread x is row group g = x % RG (rows 4 g .. 4 g + 3) of
// column group x / RG; every P steps one reduce-scatter over the row
// groups leaves each thread one (step, column) of o.
template <typename T, int HD>
__global__ void __launch_bounds__(Local<HD>::THREADS)
wkv6_kernel(Args a) {
  using G = Local<HD>;
  constexpr int RG = G::RG, J = G::J, P = G::P, THREADS = G::THREADS;
  constexpr int COLS = G::COLS;
  __shared__ __align__(16) float sr[TS * HD], sk[TS * HD], sw[TS * HD], sv[TS * COLS];
  __shared__ float sruk[TS], su[HD];

  const int cb = blockIdx.z * COLS;                 // the block's first column
  const int tid = threadIdx.x, g = tid % RG, col0 = cb + (tid / RG) * J;
  const bool tile0 = blockIdx.z == 0;               // writes q and Δ_c
  const int bh = blockIdx.x, c = blockIdx.y;
  const int h = bh % a.h;
  const long long b = bh / a.h;
  const int t_begin = c * a.chunk, t_end = min(a.t, t_begin + a.chunk);
  const bool one_chunk = a.scr == nullptr;
  const long long stride = (long long)a.h * HD;                 // between steps
  auto first = [&](int t0) { return ((b * a.t + t0) * a.h + h) * HD; };

  Run<T, HD, THREADS> rr, kk;
  Run<T, COLS, THREADS> vv;
  Run<float, HD, THREADS> ww;
  auto fetch = [&](int t0) {
    const int n = min(TS, t_end - t0);
    rr.load(static_cast<const T*>(a.r), first(t0), stride, n, tid);
    kk.load(static_cast<const T*>(a.k), first(t0), stride, n, tid);
    vv.load(static_cast<const T*>(a.v), first(t0) + cb, stride, n, tid);
    ww.load(a.w, first(t0), stride, n, tid);
  };
  fetch(t_begin);
  if (tid < HD) su[tid] = a.u[h * HD + tid];

  // s[m][x] is row 4 g + m, column col0 + x
  const long long head = (long long)bh * HD * HD + (long long)(4 * g) * HD + col0;
  float s[4][J];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    if (one_chunk && a.s0) load_row<J>(a.s0 + head + m * HD, s[m]);
    else
#pragma unroll
      for (int x = 0; x < J; ++x) s[m][x] = 0.f;
  }
  float dprod = 1.f;   // thread tid < HD: row tid's decay product since t_c

  for (int t0 = t_begin; t0 < t_end; t0 += TS) {
    const int n = min(TS, t_end - t0);
    __syncthreads();               // the previous run is consumed (and su written)
    rr.store(sr, tid);
    kk.store(sk, tid);
    vv.store(sv, tid);
    ww.store(sw, tid);
    // the bonus term's Σ_i r_i u_i k_i per step, from the loaded vectors:
    // the VPR threads holding a step's vectors sum them with shuffles
    {
      using V = Run<T, HD, THREADS>;
#pragma unroll
      for (int m = 0; m < V::N; ++m) {
        const int vi = tid + m * THREADS;
        float p = 0.f;
        if (vi < TS * V::VPR) {
          float fr[V::E], fk[V::E];
          unpack<T>(rr.raw[m], fr);
          unpack<T>(kk.raw[m], fk);
          const float* u = su + (vi % V::VPR) * V::E;
#pragma unroll
          for (int x = 0; x < V::E; ++x) p += fr[x] * u[x] * fk[x];
        }
#pragma unroll
        for (int off = V::VPR / 2; off; off >>= 1) p += __shfl_xor_sync(G::MASK, p, off);
        if (vi < TS * V::VPR && vi % V::VPR == 0) sruk[vi / V::VPR] = p;
      }
    }
    __syncthreads();
    if (t0 + TS < t_end) fetch(t0 + TS);   // in flight while this run is walked
    if (!one_chunk && tile0 && tid < HD) {  // q_t = r_t ⊙ D_t for phase 3, and Δ_c
      for (int step = 0; step < n; ++step) {
        a.q[first(t0 + step) + tid] = sr[step * HD + tid] * dprod;
        dprod *= sw[step * HD + tid];
      }
    }

    // np (≤ P) steps of the walk from `step`, then their reduce-scatter; a
    // whole run is unrolled without branches
    auto walk = [&](int step, int np) {
      float part[P * J];
#pragma unroll
      for (int x = 0; x < P * J; ++x) part[x] = 0.f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (p < np) {
          const int st = step + p;
          float vj[J];
#pragma unroll
          for (int x = 0; x < J; x += 2) {
            const float2 v2 = *reinterpret_cast<const float2*>(sv + st * COLS + col0 - cb + x);
            vj[x] = v2.x;
            vj[x + 1] = v2.y;
          }
          const float4 r4 = reinterpret_cast<const float4*>(sr + st * HD)[g];
          const float4 k4 = reinterpret_cast<const float4*>(sk + st * HD)[g];
          const float4 w4 = reinterpret_cast<const float4*>(sw + st * HD)[g];
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const float ri = comp(r4, y), ki = comp(k4, y), wi = comp(w4, y);
#pragma unroll
            for (int x = 0; x < J; ++x) {
              part[p * J + x] = fmaf(ri, s[y][x], part[p * J + x]);
              s[y][x] = fmaf(wi, s[y][x], ki * vj[x]);
            }
          }
        }
      }
      reduce_scatter<RG / 2, G::MASK>(part, g);     // value g is left in part[0]
      const int st = step + g / J, j = col0 + g % J;
      if (g / J < np)
        a.o[first(t0 + st) + j] = fmaf(sv[st * COLS + j - cb], sruk[st], part[0]);
    };
    if (n == TS) {
#pragma unroll
      for (int step = 0; step < TS; step += P) walk(step, P);
    } else {
      for (int step = 0; step < n; step += P) walk(step, min(P, n - step));
    }
  }

  float* dst = one_chunk ? a.st + head
                         : a.scr + ((long long)bh * a.nc + c) * HD * HD + (4 * g) * HD + col0;
#pragma unroll
  for (int m = 0; m < 4; ++m) store_row<J>(dst + m * HD, s[m]);
  if (!one_chunk && tile0 && tid < HD) a.delta[((long long)bh * a.nc + c) * HD + tid] = dprod;
  if (!one_chunk) let_dependents_launch();
}

// Phase 2.  One thread per (b·h, i, j) state element, walking the chunks:
// slot c of the scratch holds Ŝ_c on entry and S_c on exit.
constexpr int CARRY_THREADS = 256;
constexpr int CARRY_AHEAD = 8;     // chunks whose loads are in flight at once

__global__ void __launch_bounds__(CARRY_THREADS)
wkv6_carry_kernel(Args a, int hd, long long elems) {
  wait_for_prior_grid();
  const long long e = (long long)blockIdx.x * CARRY_THREADS + threadIdx.x;
  if (e >= elems) return;
  const long long hd2 = (long long)hd * hd;
  const long long bh = e / hd2, ij = e % hd2;
  float carry = a.s0 ? a.s0[e] : 0.f;
  float* slot = a.scr + bh * a.nc * hd2 + ij;
  const float* d = a.delta + bh * a.nc * hd + ij / hd;
  for (int c = 0; c < a.nc; c += CARRY_AHEAD) {
    float loc[CARRY_AHEAD], dc[CARRY_AHEAD];
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      if (c + q < a.nc) {
        loc[q] = slot[(c + q) * hd2];
        dc[q] = d[(long long)(c + q) * hd];
      }
    }
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      if (c + q < a.nc) {
        slot[(c + q) * hd2] = carry;
        carry = fmaf(dc[q], carry, loc[q]);
      }
    }
  }
  let_dependents_launch();
  a.st[e] = carry;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}

// Phase 3.  Grid (B·H, ceil(T / TQ)): one block per TQ-step tile (TQ
// divides C, so a tile lies in one chunk), HD threads.  Thread x takes
// steps tg + 8 m (m < 4, tg = x / (HD / 8)) and columns 8 (x % (HD / 8))
// .. + 7 of o_t = ô_t + S_cᵀ q_t, q_t = r_t ⊙ D_t from phase 1: per 4 rows
// of S_c it reads 12 float4 for 128 multiply-adds.  q's rows are padded by
// 4 floats so a warp's step lanes hit distinct banks.
constexpr int FIX_LANES = 8;      // step lanes of a phase 3 block

template <int HD>
__global__ void __launch_bounds__(FIX_LANES * HD / 8)
wkv6_fix_kernel(Args a) {
  constexpr int CG = HD / 8, QS = HD + 4, M = TQ / FIX_LANES, THREADS = FIX_LANES * CG;
  __shared__ __align__(16) float sS[HD * HD];
  __shared__ __align__(16) float sq[TQ * QS];

  const int tid = threadIdx.x, tg = tid / CG, j0 = (tid % CG) * 8;
  const int bh = blockIdx.x, t0 = blockIdx.y * TQ, c = t0 / a.chunk;
  const int h = bh % a.h;
  const long long b = bh / a.h;
  const int n = min(TQ, a.t - t0);
  auto first = [&](int t) { return ((b * a.t + t) * a.h + h) * HD; };

  wait_for_prior_grid();
  for (int idx = tid; idx < TQ * HD / 4; idx += THREADS) {
    const int step = idx / (HD / 4), col = (idx % (HD / 4)) * 4;
    if (step < n) cp_async16(sq + step * QS + col, a.q + first(t0 + step) + col);
    else *reinterpret_cast<float4*>(sq + step * QS + col) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float* src = a.scr + ((long long)bh * a.nc + c) * HD * HD;
  for (int idx = tid; idx < HD * HD / 4; idx += THREADS)
    cp_async16(sS + 4 * idx, src + 4 * idx);
  asm volatile("cp.async.commit_group;\n" ::);
  // the sums start from the local outputs, loaded while the copies fly
  float acc[M][8];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (tg + FIX_LANES * m < n) load_row<8>(a.o + first(t0 + tg + FIX_LANES * m) + j0, acc[m]);
    else
#pragma unroll
      for (int x = 0; x < 8; ++x) acc[m][x] = 0.f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

#pragma unroll 2
  for (int i = 0; i < HD; i += 4) {
    float4 s4[4][2];
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      s4[y][0] = *reinterpret_cast<const float4*>(sS + (i + y) * HD + j0);
      s4[y][1] = *reinterpret_cast<const float4*>(sS + (i + y) * HD + j0 + 4);
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const float4 q4 = *reinterpret_cast<const float4*>(sq + (tg + FIX_LANES * m) * QS + i);
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const float qv = comp(q4, y);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          acc[m][x] = fmaf(qv, comp(s4[y][0], x), acc[m][x]);
          acc[m][4 + x] = fmaf(qv, comp(s4[y][1], x), acc[m][4 + x]);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
    if (tg + FIX_LANES * m < n)
      store_row<8>(a.o + first(t0 + tg + FIX_LANES * m) + j0, acc[m]);
}

template <typename T, int HD>
cudaError_t launch(const Args& a, int bh, cudaStream_t stream) {
  wkv6_kernel<T, HD><<<dim3(bh, a.nc, HD / Local<HD>::COLS), Local<HD>::THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.scr == nullptr) return err;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  const long long elems = (long long)bh * HD * HD;
  cfg.gridDim = dim3((unsigned)((elems + CARRY_THREADS - 1) / CARRY_THREADS));
  cfg.blockDim = dim3(CARRY_THREADS);
  err = cudaLaunchKernelEx(&cfg, wkv6_carry_kernel, a, HD, elems);
  if (err != cudaSuccess) return err;
  cfg.gridDim = dim3(bh, (a.t + TQ - 1) / TQ);
  cfg.blockDim = dim3(FIX_LANES * HD / 8);
  return cudaLaunchKernelEx(&cfg, wkv6_fix_kernel<HD>, a);
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

// dtype of r, k, v: 0 float32, 1 bfloat16; w, u, s0, o, st and scratch are
// float32.  All tensors contiguous, r, k, v and w starting on 16 bytes:
// r, k, v, w, o (B, T, H, hd); u (H, hd);
// s0 and st (B, H, hd, hd).  s0 may be null (zero state) and may equal st.
// Time is cut into chunks of `chunk` steps (a multiple of 32); when
// T > chunk, scratch holds B·H·(nc·(hd² + hd) + T·hd) floats, nc =
// ceil(T / chunk), and three kernels run, else one and scratch may be
// null.  Returns the first failed launch's error.
int wkv6_launch(int dtype, const void* r, const void* k, const void* v,
                const float* w, const float* u, const float* s0, float* o,
                float* st, float* scratch, int batch, int t, int h, int hd,
                int chunk, void* stream) {
  if (batch <= 0 || t <= 0 || h <= 0 || chunk <= 0 ||
      (long long)batch * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int nc = (t + chunk - 1) / chunk;
  if (nc > 65535 || (nc > 1 && (scratch == nullptr || chunk % TQ)) ||
      (t + TQ - 1) / TQ > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.r = r; a.k = k; a.v = v; a.w = w; a.u = u; a.s0 = s0; a.o = o; a.st = st;
  a.scr = nc > 1 ? scratch : nullptr;
  a.delta = nc > 1 ? a.scr + (long long)batch * h * nc * hd * hd : nullptr;
  a.q = nc > 1 ? a.delta + (long long)batch * h * nc * hd : nullptr;
  a.t = t; a.h = h; a.chunk = chunk; a.nc = nc;
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
