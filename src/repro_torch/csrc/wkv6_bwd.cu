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
//   wkv6_bwd_local_kernel, wkv6_bwd_carry_kernel, wkv6_bwd_kernel and
//       wkv6_bwd_finish_kernel are the gradient of wkv6_kernel /
//       wkv6_carry_kernel / wkv6_fix_kernel (wkv6.cu), which replace the
//       Pallas kernel `_wkv_kernel` (repro/kernels/rwkv6/kernel.py).  The
//       JAX package writes no backward kernel: its trainer differentiates
//       its jnp scan with jax.grad, and this is that gradient
//       (wkv6_bwd_ref is the plain version, wkv6_bwd_chunked_ref the plain
//       version of this algebra).  r, k, v in f32 or bf16, w, u, the
//       states, do and every sum in f32; dr, dk, dv leave in r's dtype, dw,
//       du and ds0 in f32.
//
// What bounds it on an H100.  Operations: per (b, t, h, i, j) the state's
// recompute (a multiply and a multiply-add, 3 flops), G's update (3), and
// one multiply-add each for dr, dk, dw and dv (8): 14 flops.  At rwkv6-3b's
// 40 heads of 64 and B 1, T 1024 that is 2.35 GFLOP, 35.1 us at 67 TFLOP/s
// of f32; its bytes (r, k, v, dr, dk, dv in bf16, w, do, dw in f32, 24 B a
// (b, t, h, i)) are 63 MB, 18.8 us at 3.35 TB/s.
//
// Design: the forward's time-chunked scan, run in reverse.  One block per
// (b, h) walking all of time leaves most of the card empty and serial, so
// time is cut into chunks of C steps (the wrapper's BWD_CHUNK: 32, 64 or
// 128), chunk c carrying in the state S_c and ending with the gradient
// G^end_c of the state at its last step:
//
//   1. wkv6_bwd_local_kernel, in parallel over (b·h, chunk, direction):
//      each chunk's walks from zero, written as products of decays (no
//      ratio): its local end state Ŝ_c = Σ_t diag(Π_{τ>t} w_τ) k_t v_tᵀ (not
//      for the last chunk), its local gradient Ĝ_c = Σ_t diag(Π_{τ<t} w_τ)
//      r_t do_tᵀ (the walk G ← diag(w_t) G + r_t do_tᵀ from zero at its
//      end) and its decay product Δ_c = Π w, each a (hd x C)·(C x hd)
//      product.
//   2. wkv6_bwd_carry_kernel, sequential over chunks and in parallel over
//      (b·h, i, j): S_0 = s0, S_{c+1} = diag(Δ_c) S_c + Ŝ_c, and
//      G^end_{nc-1} = dsT, G^end_{c-1} = diag(Δ_c) G^end_c + Ĝ_c, each
//      slot of the workspace swapping the local value for the carried one.
//   3. wkv6_bwd_kernel, in parallel over (b·h, chunk, row tile): the walk
//      below inside each chunk, from (S_c, G^end_c).
//   4. wkv6_bwd_finish_kernel: dv's row tiles and du's chunks and batch
//      rows summed in a fixed order.
//   A call of at most C steps is one chunk: kernels 3 and 4 alone, from s0
//   and dsT.  Kernels 2-4 are programmatic dependent launches (Hopper's
//   griddepcontrol): each starts while the one before drains, and kernel 3
//   stages its first inputs before it waits for the carry's results.
//
// The walk of kernel 3.  S_{t-1} is needed in reverse order and is never
// recovered by dividing by w_t (w = exp(-exp(decay)) reaches 1e-30 and
// below at trained decays): the block walks its chunk forward once from S_c,
// keeping the state at the start of every sub-chunk of SUB steps in shared
// memory (each thread its own elements), then takes the sub-chunks from
// the last, recomputes each one's SUB states into registers and walks them
// back with G.  S and G evolve element by element, so a block takes one
// (b, h), a chunk and a tile of RT rows, all hd columns: lane x of warp y
// holds row x of the tile and columns 8 y .. 8 y + 7 of S, G and the
// sub-chunk's states.  The sums over columns (dr, dk, dw) go through shared
// memory per warp and are added in warp order; dv's sum over the rows of a
// warp is a reduce-scatter of shuffles, over the row tiles (two at hd 64)
// kernel 4 adds the tiles' f32 partials in order, and du's partials of each
// (batch row, chunk) too.  No float atomics: a repeat gives the same bits.
// A run's r, k, w, v, do arrive by cp.async two runs ahead, into one of two
// raw slots, and are widened to f32 (with each step's v·do and Σ r u k)
// when the run begins.  Two blocks of 8 warps fit an SM at C = 64 (SUB · 8
// state registers a thread, 7 checkpoints of 8 KB); 128-step chunks leave
// one.  Kernel 3 takes about three quarters of a call at rwkv6-3b's shape;
// the latency of each step's dependent chains, not the card's issue or
// memory rate, holds it (PERF.md §6).
//
// The sum is exact: S_{t-1} and G_t of a chunk are its carried values
// walked the same recurrence; products of decays that underflow to 0 are
// the true values' rounding.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int SUB = 8;     // steps a thread holds in registers in the walk (kernel 3)
constexpr int LSUB = 16;   // steps a run of the local walks stages (kernel 1)
constexpr int CJ = 8;      // columns a thread holds
constexpr unsigned FULL = 0xffffffffu;

// the inputs a run stages
constexpr int IN_R = 1, IN_K = 2, IN_V = 4, IN_W = 8, IN_D = 16;
constexpr int IN_ALL = IN_R | IN_K | IN_V | IN_W | IN_D;

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
  float* sc;          // (B·H, nc, hd, hd): Ŝ_c, then S_c (null for one chunk)
  float* gc;          // (B·H, nc, hd, hd): Ĝ_c, then G^end_c (null for one chunk)
  float* delta;       // (B·H, nc, hd) (null for one chunk)
  float* dvp;         // (tiles, B, T, H, hd) dv partials
  float* dup;         // (B, nc, H, hd) du partials
  int b, t, h, chunk, nc;
};

// Programmatic dependent launch (Hopper): kernels 2-4 are launched while
// the kernel before them finishes, and wait here for its results.
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void let_dependents_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void load8(const float* p, float (&x)[CJ]) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + 4);
  x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
  x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
}
__device__ __forceinline__ void store8(float* p, const float (&x)[CJ]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(x[4], x[5], x[6], x[7]);
}

template <int HD>
struct Geo {
  static constexpr int RT = HD < 32 ? HD : 32;      // rows per block (one a lane)
  static constexpr int TILES = HD / RT;             // row tiles
  static constexpr int WARPS = HD / CJ;             // column groups
  static constexpr int THREADS = 32 * WARPS;
};

// A run of STEPS steps of the inputs in shared memory: two slots of raw
// copies (r, k, v as T, then w, do as f32, [STEPS][HD] each; the run after
// next lands in the slot this run leaves) and the f32 widening of this run
// (r, k, w, v, do, then each step's v·do and Σ r u k, then u).
template <typename T, int HD, int STEPS>
struct Run {
  static constexpr int RAW = STEPS * HD * (3 * (int)sizeof(T) + 8);   // bytes a slot
  static constexpr int F32 = 5 * STEPS * HD + 2 * STEPS + HD;          // floats
  static constexpr int BYTES = 2 * RAW + 4 * F32;
  static_assert(RAW % 16 == 0 && (4 * F32) % 16 == 0, "16-byte regions");
  unsigned char* raw;
  float *r, *k, *w, *v, *d, *vdo, *ruk, *u;

  __device__ explicit Run(unsigned char* base) : raw(base) {
    r = reinterpret_cast<float*>(base + 2 * RAW);
    k = r + STEPS * HD;
    w = k + STEPS * HD;
    v = w + STEPS * HD;
    d = v + STEPS * HD;
    vdo = d + STEPS * HD;
    ruk = vdo + STEPS;
    u = ruk + STEPS;
  }
  __device__ float* end() const { return u + HD; }
  // raw input x (0 r, 1 k, 2 v as T; 3 w, 4 do as f32) of a slot
  __device__ T* raw_t(int slot, int x) const {
    return reinterpret_cast<T*>(raw + slot * RAW) + x * STEPS * HD;
  }
  __device__ float* raw_f(int slot, int x) const {
    return reinterpret_cast<float*>(raw + slot * RAW + 3 * STEPS * HD * sizeof(T)) +
           (x - 3) * STEPS * HD;
  }

  // cp.async the named inputs of n steps into a slot; `first` is element
  // (b, t0, h, 0).  Commits one group, empty when n is 0.
  template <typename E>
  __device__ static void copy(E* dst, const E* src, long long first, long long stride, int n,
                              int tid, int threads) {
    constexpr int PER = 16 / sizeof(E), VPR = HD / PER;   // 16-byte copies a step
    for (int x = tid; x < n * VPR; x += threads) {
      const int s = x / VPR, col = (x % VPR) * PER;
      cp_async16(dst + s * HD + col, src + first + s * stride + col);
    }
  }
  __device__ void issue(int slot, const Args& a, long long first, long long stride, int n,
                        int which, int tid, int threads) {
    if (which & IN_R) copy(raw_t(slot, 0), static_cast<const T*>(a.r), first, stride, n, tid, threads);
    if (which & IN_K) copy(raw_t(slot, 1), static_cast<const T*>(a.k), first, stride, n, tid, threads);
    if (which & IN_V) copy(raw_t(slot, 2), static_cast<const T*>(a.v), first, stride, n, tid, threads);
    if (which & IN_W) copy(raw_f(slot, 3), a.w, first, stride, n, tid, threads);
    if (which & IN_D) copy(raw_f(slot, 4), a.dout, first, stride, n, tid, threads);
    cp_async_commit();
  }

  // widen the named inputs to f32; steps past n read w 1 and the rest 0
  // (an identity step); with `sums`, each step's v·do and Σ r u k
  template <int which, bool sums>
  __device__ void widen(int slot, int n, int warp, int lane, int warps) {
    const T *rr = raw_t(slot, 0), *rk = raw_t(slot, 1), *rv = raw_t(slot, 2);
    const float *rw = raw_f(slot, 3), *rd = raw_f(slot, 4);
    for (int s = warp; s < STEPS; s += warps) {
      const bool ok = s < n;
      float vdo_s = 0.f, ruk_s = 0.f;
      for (int x = lane; x < HD; x += 32) {
        const int e = s * HD + x;
        const float fr = (which & IN_R) && ok ? ld(rr + e) : 0.f;
        const float fk = (which & IN_K) && ok ? ld(rk + e) : 0.f;
        const float fv = (which & IN_V) && ok ? ld(rv + e) : 0.f;
        const float fd = (which & IN_D) && ok ? rd[e] : 0.f;
        if (which & IN_R) r[e] = fr;
        if (which & IN_K) k[e] = fk;
        if (which & IN_V) v[e] = fv;
        if (which & IN_W) w[e] = ok ? rw[e] : 1.f;
        if (which & IN_D) d[e] = fd;
        if (sums) {
          vdo_s = fmaf(fv, fd, vdo_s);
          ruk_s = fmaf(fr * u[x], fk, ruk_s);
        }
      }
      if (sums) {
#pragma unroll
        for (int off = 16; off; off >>= 1) {
          vdo_s += __shfl_xor_sync(FULL, vdo_s, off);
          ruk_s += __shfl_xor_sync(FULL, ruk_s, off);
        }
        if (lane == 0) {
          vdo[s] = vdo_s;
          ruk[s] = ruk_s;
        }
      }
    }
  }
};

// Kernel 1.  Grid (B·H, nc, 2): z 0 gives the chunk's local end state
// Ŝ_c = Σ_t diag(Π_{τ>t} w_τ) k_t v_tᵀ (nothing for the last chunk), z 1
// its local gradient Ĝ_c = Σ_t diag(Π_{τ<t} w_τ) r_t do_tᵀ and Δ_c = Π w:
// the walks from zero written as products of decays (suffix and prefix
// products over the chunk, no ratio), then a (hd x C)·(C x hd) product on
// CUDA cores, 4 x 4 outputs a thread.
template <int HD>
struct Local {
  static constexpr int G4 = HD / 4;                      // 4-wide groups a row
  static constexpr int OUT = G4 * G4;                    // threads with outputs
  static constexpr int THREADS = OUT < 32 ? 32 : OUT;
};

template <typename T, int HD, bool BACK>
__device__ __forceinline__ void local_products(const Args& a, unsigned char* smem) {
  using L = Local<HD>;
  using R = Run<T, HD, LSUB>;
  constexpr int THREADS = L::THREADS, WARPS = THREADS / 32;
  constexpr int WHICH = BACK ? IN_R | IN_W | IN_D : IN_K | IN_V | IN_W;
  R run(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, c = blockIdx.y;
  const int h = bh % a.h;
  const long long b = bh / a.h;
  const long long stride = (long long)a.h * HD;
  auto at = [&](int t) { return ((b * a.t + t) * a.h + h) * HD; };
  const int t_begin = c * a.chunk, len = min(a.chunk, a.t - t_begin);
  const int nrun = (len + LSUB - 1) / LSUB;
  // prefix products run from the chunk's first step, suffix products from its last
  auto t0_of = [&](int q) { return t_begin + (BACK ? q : nrun - 1 - q) * LSUB; };
  auto issue = [&](int q) {          // run q into slot q % 2 (nothing past the last)
    const int t0 = t0_of(q);
    run.issue(q & 1, a, at(t0), stride, q < nrun ? min(LSUB, t_begin + len - t0) : 0, WHICH,
              tid, THREADS);
  };
  issue(0);
  issue(1);

  // thread: rows r0 .. r0 + 3, columns c0 .. c0 + 3, and its rows' running
  // products of w (each thread keeps its own: no serial pass, no barrier)
  const bool out = tid < L::OUT;
  const int r0 = out ? 4 * (tid / L::G4) : 0, c0 = out ? 4 * (tid % L::G4) : 0;
  float acc[4][4], prod[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
  for (int y = 0; y < 4; ++y)
#pragma unroll
    for (int x = 0; x < 4; ++x) acc[y][x] = 0.f;
  const float* sx = BACK ? run.r : run.k;
  const float* sy = BACK ? run.d : run.v;
  for (int q = 0; q < nrun; ++q) {
    const int n = min(LSUB, t_begin + len - t0_of(q));
    cp_async_wait_prior();
    __syncthreads();                    // the run has landed; the run before is consumed
    run.template widen<WHICH, false>(q & 1, n, warp, lane, WARPS);
    __syncthreads();
    issue(q + 2);                       // lands while this run and the next are used
#pragma unroll 4
    for (int m = 0; m < LSUB; ++m) {    // steps past n: x 0, w 1
      const int s = BACK ? m : LSUB - 1 - m;
      const float4 xv = *reinterpret_cast<const float4*>(sx + s * HD + r0);
      const float4 yv = *reinterpret_cast<const float4*>(sy + s * HD + c0);
      const float4 wv = *reinterpret_cast<const float4*>(run.w + s * HD + r0);
      const float xs[4] = {xv.x * prod[0], xv.y * prod[1], xv.z * prod[2], xv.w * prod[3]};
      const float ys[4] = {yv.x, yv.y, yv.z, yv.w};
      prod[0] *= wv.x; prod[1] *= wv.y; prod[2] *= wv.z; prod[3] *= wv.w;
#pragma unroll
      for (int y = 0; y < 4; ++y)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[y][x] = fmaf(xs[y], ys[x], acc[y][x]);
    }
  }
  if (out) {
    float* dst = (BACK ? a.gc : a.sc) + ((long long)bh * a.nc + c) * HD * HD;
#pragma unroll
    for (int y = 0; y < 4; ++y)
      *reinterpret_cast<float4*>(dst + (r0 + y) * HD + c0) =
          make_float4(acc[y][0], acc[y][1], acc[y][2], acc[y][3]);
    if (BACK && c0 == 0)
      *reinterpret_cast<float4*>(a.delta + ((long long)bh * a.nc + c) * HD + r0) =
          make_float4(prod[0], prod[1], prod[2], prod[3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Local<HD>::THREADS, 3) wkv6_bwd_local_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  if (blockIdx.z == 1) local_products<T, HD, true>(a, smem);
  else if (blockIdx.y < a.nc - 1) local_products<T, HD, false>(a, smem);   // the last Ŝ is not needed
  let_dependents_launch();
}

// Kernel 2.  One thread per (b·h, i, j) state element, walking the chunks
// forward for S_c and back for G^end_c.
constexpr int CARRY_THREADS = 256;
constexpr int CARRY_AHEAD = 16;    // chunks whose loads are in flight at once

__global__ void __launch_bounds__(CARRY_THREADS)
wkv6_bwd_carry_kernel(Args a, int hd, long long elems) {
  wait_for_prior_grid();
  let_dependents_launch();           // kernel 3 stages its inputs meanwhile
  const long long e = (long long)blockIdx.x * CARRY_THREADS + threadIdx.x;
  if (e >= elems) return;
  const long long hd2 = (long long)hd * hd;
  const long long bh = e / hd2, ij = e % hd2;
  float* ss = a.sc + bh * a.nc * hd2 + ij;
  float* gs = a.gc + bh * a.nc * hd2 + ij;
  const float* d = a.delta + bh * a.nc * hd + ij / hd;
  float carry = a.s0 ? a.s0[e] : 0.f;
  for (int c = 0; c < a.nc; c += CARRY_AHEAD) {
    float loc[CARRY_AHEAD], dc[CARRY_AHEAD];
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      if (c + q < a.nc - 1) {         // the last chunk has no Ŝ
        loc[q] = ss[(c + q) * hd2];
        dc[q] = d[(long long)(c + q) * hd];
      }
    }
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      if (c + q < a.nc) ss[(c + q) * hd2] = carry;
      if (c + q < a.nc - 1) carry = fmaf(dc[q], carry, loc[q]);
    }
  }
  carry = a.dsT ? a.dsT[e] : 0.f;
  for (int c = a.nc - 1; c >= 0; c -= CARRY_AHEAD) {
    float loc[CARRY_AHEAD], dc[CARRY_AHEAD];
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      if (c - q >= 1) {                // chunk 0's Ĝ only makes ds0 (kernel 3 walks it)
        loc[q] = gs[(c - q) * hd2];
        dc[q] = d[(long long)(c - q) * hd];
      }
    }
#pragma unroll
    for (int q = 0; q < CARRY_AHEAD; ++q) {
      if (c - q >= 0) gs[(c - q) * hd2] = carry;
      if (c - q >= 1) carry = fmaf(dc[q], carry, loc[q]);
    }
  }
}

// Kernel 3.  Grid (B·H, nc, TILES), chunks of CB steps.  See the note above.
template <typename T, int HD, int CB>
struct Walk {
  using G = Geo<HD>;
  static constexpr int M = CB / SUB;        // sub-chunks a chunk
  static constexpr int RED = 3 * SUB * G::WARPS * 32;
  static constexpr int SMEM =
      Run<T, HD, SUB>::BYTES + 4 * (RED + SUB * HD) + (M - 1) * G::THREADS * 32;
};

template <typename T, int HD, int CB>
__global__ void __launch_bounds__(Geo<HD>::THREADS, 2) wkv6_bwd_kernel(Args a) {
  using G = Geo<HD>;
  using R = Run<T, HD, SUB>;
  constexpr int RT = G::RT, WARPS = G::WARPS, THREADS = G::THREADS;
  constexpr int RS = SUB * WARPS * 32;      // one of the three column sums
  extern __shared__ __align__(16) unsigned char smem[];
  R run(smem);
  float* red = run.end();                   // [3][SUB][WARPS][32]
  float* sdv = red + 3 * RS;                // [SUB][HD] the warps' dv sums
  float4* ckpt = reinterpret_cast<float4*>(sdv + SUB * HD);   // [M - 1][2][THREADS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x, c = blockIdx.y, tile = blockIdx.z;
  const int h = bh % a.h;
  const long long b = bh / a.h;
  const bool row_ok = lane < RT;
  const int i = row_ok ? tile * RT + lane : 0;   // this lane's row
  const int j0 = warp * CJ;                      // this warp's first column
  // the column whose sum over the warp's rows the lane holds after dv's reduce-scatter
  const int jl = j0 + ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
  const long long stride = (long long)a.h * HD;
  auto at = [&](int t) { return ((b * a.t + t) * a.h + h) * HD; };   // (b, t, h, 0)
  const long long head = (long long)bh * HD * HD;
  const int t_begin = c * CB, len = min(CB, a.t - t_begin), nsub = (len + SUB - 1) / SUB;
  const int items = 2 * nsub - 1;
  // run q: sub-chunks 0 .. nsub - 2 forward (the checkpoints), then nsub - 1 .. 0 back
  auto sub_of = [&](int q) { return q < nsub - 1 ? q : 2 * nsub - 2 - q; };
  auto which_of = [&](int q) { return q < nsub - 1 ? IN_K | IN_V | IN_W : IN_ALL; };
  auto issue = [&](int q) {                      // run q into slot q % 2 (nothing past the last)
    const int t0 = t_begin + sub_of(q) * SUB;
    run.issue(q & 1, a, at(t0), stride, q < items ? min(SUB, t_begin + len - t0) : 0,
              which_of(q), tid, THREADS);
  };
  issue(0);                                      // inputs only: before the wait
  issue(1);
  if (tid < HD) run.u[tid] = a.u[h * HD + tid];
  wait_for_prior_grid();                         // S_c and G^end_c come from the carry

  const long long slot = ((long long)bh * a.nc + c) * HD * HD;
  const float* s_src = a.nc > 1 ? a.sc + slot : a.s0 ? a.s0 + head : nullptr;
  const float* g_src = a.nc > 1 ? a.gc + slot : a.dsT ? a.dsT + head : nullptr;
  auto load_rows = [&](const float* src, float (&x)[CJ]) {
    if (row_ok && src) load8(src + (long long)i * HD + j0, x);
    else
#pragma unroll
      for (int e = 0; e < CJ; ++e) x[e] = 0.f;
  };

  float g[CJ];
  float du_acc = 0.f;
  float* dvp = a.dvp + (long long)tile * a.b * a.t * stride;
  {
    float x[CJ];
    load_rows(s_src, x);
    for (int q = 0; q < nsub - 1; ++q) {        // forward: the checkpoints
      cp_async_wait_prior();
      __syncthreads();
      run.template widen<IN_K | IN_V | IN_W, false>(q & 1, SUB, warp, lane, WARPS);
      __syncthreads();
      issue(q + 2);
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
        const float wi = row_ok ? run.w[s * HD + i] : 0.f, ki = row_ok ? run.k[s * HD + i] : 0.f;
        float vj[CJ];
        load8(run.v + s * HD + j0, vj);
#pragma unroll
        for (int e = 0; e < CJ; ++e) x[e] = fmaf(wi, x[e], ki * vj[e]);
      }
      ckpt[(2 * q) * THREADS + tid] = make_float4(x[0], x[1], x[2], x[3]);
      ckpt[(2 * q + 1) * THREADS + tid] = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
  load_rows(g_src, g);

  for (int q = nsub - 1; q < items; ++q) {      // back: each sub-chunk recomputed, then walked
    const int sub = sub_of(q), t0 = t_begin + sub * SUB, n = min(SUB, t_begin + len - t0);
    cp_async_wait_prior();
    __syncthreads();                           // the run has landed; the run before is consumed
    run.template widen<IN_ALL, true>(q & 1, n, warp, lane, WARPS);
    __syncthreads();
    issue(q + 2);                              // lands while this run and the next are walked

    // the sub-chunk's states S_{t-1}, t = t0 .. t0 + SUB - 1
    float sp[SUB][CJ];
    {
      float x[CJ];
      if (sub == 0) {
        load_rows(s_src, x);
      } else {
        const float4 lo = ckpt[(2 * (sub - 1)) * THREADS + tid];
        const float4 hi = ckpt[(2 * (sub - 1) + 1) * THREADS + tid];
        x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
        x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
      }
#pragma unroll
      for (int s = 0; s < SUB; ++s) {
#pragma unroll
        for (int e = 0; e < CJ; ++e) sp[s][e] = x[e];
        if (s + 1 < SUB) {
          const float wi = row_ok ? run.w[s * HD + i] : 0.f, ki = row_ok ? run.k[s * HD + i] : 0.f;
          float vj[CJ];
          load8(run.v + s * HD + j0, vj);
#pragma unroll
          for (int e = 0; e < CJ; ++e) x[e] = fmaf(wi, x[e], ki * vj[e]);
        }
      }
    }

#pragma unroll
    for (int s = SUB - 1; s >= 0; --s) {        // steps past n are identities
      const float ri = row_ok ? run.r[s * HD + i] : 0.f;
      const float ki = row_ok ? run.k[s * HD + i] : 0.f;
      const float wi = row_ok ? run.w[s * HD + i] : 0.f;
      float vj[CJ], dj[CJ], p[CJ];
      load8(run.v + s * HD + j0, vj);
      load8(run.d + s * HD + j0, dj);
      float pr = 0.f, pk = 0.f, pw = 0.f;
#pragma unroll
      for (int e = 0; e < CJ; ++e) {
        pr = fmaf(sp[s][e], dj[e], pr);
        pk = fmaf(g[e], vj[e], pk);
        pw = fmaf(g[e], sp[s][e], pw);
        p[e] = g[e] * ki;
        g[e] = fmaf(wi, g[e], ri * dj[e]);
      }
      float* rs = red + (s * WARPS + warp) * 32 + lane;
      rs[0] = pr;
      rs[RS] = pk;
      rs[2 * RS] = pw;
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
      sdv[s * HD + jl] = p[0];                  // the 4 lanes of a column store one value
    }
    __syncthreads();

    // dv's partial of this tile (the bonus term in tile 0's), then dr, dk,
    // dw of the sub-chunk's steps and this tile's rows: the warps' column
    // sums in warp order, plus the bonus terms
    for (int e = tid; e < SUB * HD; e += THREADS) {
      const int s = e / HD, j = e % HD;
      if (s >= n) continue;
      float x = sdv[e];
      if (tile == 0) x = fmaf(run.ruk[s], run.d[e], x);
      dvp[at(t0 + s) + j] = x;
    }
    for (int e = tid; e < SUB * RT; e += THREADS) {
      const int s = e / RT, x = e % RT;
      if (s >= n) continue;
      float pr = 0.f, pk = 0.f, pw = 0.f;
      for (int y = 0; y < WARPS; ++y) {
        const float* rs = red + (s * WARPS + y) * 32 + x;
        pr += rs[0];
        pk += rs[RS];
        pw += rs[2 * RS];
      }
      const int row = tile * RT + x;
      const float ux = run.u[row], vdo = run.vdo[s];
      const long long off = at(t0 + s) + row;
      st(static_cast<T*>(a.dr) + off, fmaf(ux * run.k[s * HD + row], vdo, pr));
      st(static_cast<T*>(a.dk) + off, fmaf(ux * run.r[s * HD + row], vdo, pk));
      a.dw[off] = pw;
    }
    if (warp == 0 && row_ok) {
      for (int s = 0; s < n; ++s)
        du_acc = fmaf(run.r[s * HD + i] * run.k[s * HD + i], run.vdo[s], du_acc);
    }
  }
  if (row_ok) {
    if (c == 0) store8(a.ds0 + head + (long long)i * HD + j0, g);
    if (warp == 0) a.dup[((b * a.nc + c) * a.h + h) * HD + i] = du_acc;
  }
  let_dependents_launch();
}

// Kernel 4.  dv = the row tiles' partials summed in tile order (in r's
// dtype); du = the (batch row, chunk) partials summed in that order.
template <typename T>
__global__ void __launch_bounds__(256) wkv6_bwd_finish_kernel(Args a, int hd, int tiles) {
  wait_for_prior_grid();
  const long long e = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long n_dv = (long long)a.b * a.t * a.h * hd, n_du = (long long)a.h * hd;
  if (e < n_dv) {
    float x = a.dvp[e];
    for (int y = 1; y < tiles; ++y) x += a.dvp[y * n_dv + e];
    st(static_cast<T*>(a.dv) + e, x);
  } else if (e < n_dv + n_du) {
    const long long f = e - n_dv;
    float x = 0.f;
    for (long long y = 0; y < (long long)a.b * a.nc; ++y) x += a.dup[y * n_du + f];
    a.du[f] = x;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
      ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
      : cudaSuccess;
}

template <typename T, int HD, int CB>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using G = Geo<HD>;
  const unsigned bh = (unsigned)(a.b * a.h);
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = stream;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  cudaError_t err;
  if (a.nc > 1) {
    auto local = wkv6_bwd_local_kernel<T, HD>;
    constexpr int LS = Run<T, HD, LSUB>::BYTES;
    if ((err = allow_smem(local, LS)) != cudaSuccess) return err;
    local<<<dim3(bh, a.nc, 2), Local<HD>::THREADS, LS, stream>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const long long elems = (long long)bh * HD * HD;
    cfg.gridDim = dim3((unsigned)((elems + CARRY_THREADS - 1) / CARRY_THREADS));
    cfg.blockDim = dim3(CARRY_THREADS);
    if ((err = cudaLaunchKernelEx(&cfg, wkv6_bwd_carry_kernel, a, HD, elems)) != cudaSuccess)
      return err;
  }
  auto walk = wkv6_bwd_kernel<T, HD, CB>;
  constexpr int WS = Walk<T, HD, CB>::SMEM;
  if ((err = allow_smem(walk, WS)) != cudaSuccess) return err;
  cfg.gridDim = dim3(bh, a.nc, G::TILES);
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = WS;
  cfg.numAttrs = a.nc > 1 ? 1 : 0;    // first of its call: waits for the stream as usual
  if ((err = cudaLaunchKernelEx(&cfg, walk, a)) != cudaSuccess) return err;
  const long long n = (long long)a.b * a.t * a.h * HD + (long long)a.h * HD;
  cfg.gridDim = dim3((unsigned)((n + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = 0;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, wkv6_bwd_finish_kernel<T>, a, HD, G::TILES);
}

template <typename T, int HD>
cudaError_t dispatch_chunk(const Args& a, cudaStream_t stream) {
  switch (a.chunk) {
    case 32: return launch<T, HD, 32>(a, stream);
    case 64: return launch<T, HD, 64>(a, stream);
    case 128: return launch<T, HD, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 8: return dispatch_chunk<T, 8>(a, stream);
    case 16: return dispatch_chunk<T, 16>(a, stream);
    case 32: return dispatch_chunk<T, 32>(a, stream);
    case 64: return dispatch_chunk<T, 64>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

int tiles_of(int hd) { return hd > 32 ? hd / 32 : 1; }

// Blocks of the walk (kernel 3) that fit one SM, by registers and shared memory.
template <typename T, int HD, int CB>
int walk_blocks() {
  auto walk = wkv6_bwd_kernel<T, HD, CB>;
  constexpr int WS = Walk<T, HD, CB>::SMEM;
  int n = 0;
  if (allow_smem(walk, WS) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, walk, Geo<HD>::THREADS, WS) !=
          cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// f32 floats of workspace a call with chunks of `chunk` steps needs: with
// more than one chunk the carried states and gradients (2 B·H·nc·hd²) and
// decay products (B·H·nc·hd); always the row tiles' dv partials and the
// (batch row, chunk) du partials.
long long wkv6_bwd_workspace_floats(int batch, int t, int h, int hd, int chunk) {
  const long long nc = (t + chunk - 1) / chunk, bh = (long long)batch * h;
  return (nc > 1 ? bh * nc * hd * (2LL * hd + 1) : 0) +
         (long long)tiles_of(hd) * batch * t * h * hd + (long long)batch * nc * h * hd;
}

// dtype of r, k, v, dr, dk, dv: 0 float32, 1 bfloat16; everything else
// float32.  All tensors contiguous, r, k, v, w and dout starting on 16
// bytes: r, k, v, w, dout, dr, dk, dv, dw (B, T, H, hd); u, du (H, hd);
// s0, dsT, ds0 (B, H, hd, hd), s0 and dsT may be null (zero).  chunk: 32,
// 64 or 128 steps.  ws: wkv6_bwd_workspace_floats floats.  Four launches
// (two for a call of one chunk); returns the first failed one's error.
int wkv6_bwd_launch(int dtype, const void* r, const void* k, const void* v, const float* w,
                    const float* u, const float* s0, const float* dout, const float* dsT,
                    void* dr, void* dk, void* dv, float* dw, float* du, float* ds0, float* ws,
                    int batch, int t, int h, int hd, int chunk, void* stream) {
  if (batch <= 0 || t <= 0 || h <= 0 || (long long)batch * h > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int nc = (t + chunk - 1) / chunk;
  if (chunk <= 0 || nc > 65535) return (int)cudaErrorInvalidValue;
  Args a;
  a.r = r; a.k = k; a.v = v; a.w = w; a.u = u; a.s0 = s0; a.dout = dout; a.dsT = dsT;
  a.dr = dr; a.dk = dk; a.dv = dv; a.dw = dw; a.du = du; a.ds0 = ds0;
  a.b = batch; a.t = t; a.h = h; a.chunk = chunk; a.nc = nc;
  const long long bh = (long long)batch * h;
  float* p = ws;
  a.sc = a.gc = a.delta = nullptr;
  if (nc > 1) {
    a.sc = p;
    a.gc = a.sc + bh * nc * hd * hd;
    a.delta = a.gc + bh * nc * hd * hd;
    p = a.delta + bh * nc * hd;
  }
  a.dvp = p;
  a.dup = a.dvp + (long long)tiles_of(hd) * batch * t * h * hd;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_hd<float>(hd, a, s)
                  : dtype == 1 ? dispatch_hd<__nv_bfloat16>(hd, a, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}

// Steps of a sub-chunk, whose states a thread holds in registers (the
// tests cross its boundaries).
int wkv6_bwd_sub_steps() { return SUB; }

// Blocks of the walk kernel that fit one SM at hd 64 with bf16 inputs and
// chunks of `chunk` steps (its threads, registers and shared memory allow
// no more), or -1.
int wkv6_bwd_blocks_per_sm(int chunk) {
  switch (chunk) {
    case 32: return walk_blocks<__nv_bfloat16, 64, 32>();
    case 64: return walk_blocks<__nv_bfloat16, 64, 64>();
    case 128: return walk_blocks<__nv_bfloat16, 64, 128>();
    default: return -1;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
