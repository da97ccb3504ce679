// Hopper (sm_90a) kernels for the six-point Jacobi sweep (paper §1.4).
//
//   jacobi_sweep_kernel     replaces the Pallas kernel `_jacobi_kernel`
//                           (repro/kernels/jacobi/kernel.py, reached through
//                           jacobi_sweep_pallas): one sweep.
//   jacobi_two_step_kernel  replaces `_temporal_kernel`
//                           (repro/kernels/jacobi/temporal.py, reached through
//                           jacobi_two_step_pallas): two sweeps in one pass
//                           over device memory (the paper's §4 outlook).
//
// Bound: bytes.  A sweep does 6 flops per site and must read each f32 site
// once and write it once, 8 B/site: at the paper's 2400x600x600 lattice that
// is 6.91 GB, 2.06 ms at the H100's 3.35 TB/s, against 0.08 ms of f32 math
// at 67 TFLOP/s.  The two-step kernel does both sweeps in that one pass, so
// its bound is the same 2.06 ms.  The runtime sweep's slab launch (10 rows
// of the lattice, read with their two halo planes) moves 28.8 MB of rows:
// 8.6 us.
//
// Design: a plane ring fed by the Tensor Memory Accelerator.  The TPU
// kernels keep a (di, dj) tile with the whole k extent in VMEM, more than a
// block's 227 KB of shared memory here.  Instead a block owns a tile of
// TJ x TK output sites in (j, k) and marches along i over a chunk of rows.
//
//   * The producer, one thread of a warp of its own, issues one TMA tile
//     load per plane: a box of (TJ + 2 halo rows) x BOX_K floats, k from
//     k0 - 4 to k0 + TK + 3, into a ring of S shared-memory stages, each
//     with a "full" and an "empty" mbarrier.  Coordinates outside the
//     lattice arrive as zeros, which is the Dirichlet rule, so there are no
//     bounds branches on the loads.  A box row is 512 B and starts on 16 B.
//   * The consumers: warp w owns row j0 + w; lane l owns the 4 sites
//     k0 - 4 + 4l .. +3, so lanes 1..30 are the tile's TK = 120 outputs and
//     lanes 0 and 31 only carry the k halo.  A lane reads 16-byte vectors:
//     its own column of the plane above (kept in registers for the next two
//     planes, so the i neighbours cost no shared-memory reads) and the rows
//     j - 1 and j + 1 of the current plane; k - 1 and k + 1 at its edges
//     come from the neighbouring lanes by shuffle.  It stores one 16-byte
//     vector.  Once its warp has read a plane's neighbours, lane 0 releases
//     the stage to the producer, so S - 2 planes are in flight ahead.
//   * No block-wide barrier per plane: each warp waits only for the stage
//     it reads, and the producer only for the stage it refills.
//
// Bytes in flight: a stage is (TJ + 2) x 512 B, 7 KB at the wrappers' TJ 12
// with S 4.  Three blocks an SM are resident (jacobi_variant_info, printed
// by phase 1 of chip_smoke.py); each asks for all 4 stages when it starts
// and keeps 2-3 in flight as it marches, 42-84 KB an SM against the ~18 KB
// that Little's law asks (3.35 TB/s x ~0.7 us over 132 SMs).
// Shared-memory traffic per site: the TMA fill 5.0 B (halo included), three
// 16-byte reads per 4 sites over 32 lanes for 30 lanes of outputs, 12.8 B:
// about 18 B a site, 0.5 ms of the card's ~30 TB/s, under the HBM bound.
//
// The two-step kernel uses the same ring with a box of TJ + 4 rows (a 2-deep
// j halo; the 4 extra floats at each k end cover the 2-deep k halo).  Its
// TJ + 2 consumer warps compute step 1 on rows j0 - 1 .. j0 + TJ, lanes 0 and
// 31 giving the k halo of step 1 (only their inner site is used), force step
// 1 to zero outside the lattice (the TPU kernel's re-zeroed ring), keep each
// lane's own step-1 column in registers for the i neighbours and write it to
// a second ring of three step-1 planes for the j neighbours.  Step 2 (warps
// 1..TJ, lanes 1..30) lags one plane behind.  Three step-1 slots need one
// consumer barrier per plane.  At the wrappers' TJ 14: 33.5 B of
// shared-memory traffic a site (fill 5.5, step-1 reads 14.6, step-1 writes
// 4.9, step-2 reads 8.5), ~1 ms of the card's rate, under the byte bound.
// Its 544 threads are held to 2 blocks an SM (56 registers) by the launch
// bounds: at 72 registers one block fit, and the kernel lost 9-23 %.
//
// The tensor map is encoded on the host for each launch
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library needs no -lcuda).  The sweep measured an encode at 0.06-0.07 us
// against 13-20 us of host time for a whole slab launch through the
// wrapper, so a cache could save at most 0.5 % of the runtime sweep's host
// time: none is kept (and no stale map can be used).  TMA needs a 16-byte-aligned
// base and rows of nk x 4 bytes that are a multiple of 16; for any other nk
// or pointer a second instance of each kernel fills the same ring with 4-byte
// cp.async copies (zero-filled outside the lattice) and stores scalars.
//
// Both kernels sum the six neighbours in the reference's order
// (i-1, i+1, j-1, j+1, k-1, k+1) and then multiply by c: adds and one
// multiply, nothing to contract into an FMA, so they equal the plain version
// bit for bit.

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include <chrono>

namespace {

constexpr int LANES = 32;
constexpr int TK = 120;            // outputs along k: lanes 1..30, 4 sites each
constexpr int BOX_K = 4 * LANES;   // floats per box row: k0 - 4 .. k0 + TK + 3
constexpr unsigned FULL_MASK = 0xffffffffu;

// Rows of an i chunk.  One launch sweeps a range of rows; past this many it
// is cut into chunks, one per block along grid z.  Short chunks win on the
// card although each re-reads its two (four) boundary planes: a block asks
// for all S stages at its start, so many short blocks keep more bytes in
// flight than few long ones (`python -m repro_torch.kernels.jacobi.sweep`:
// K1 at 2400x600x600 took 2.45 ms at 10 rows against 2.73 at 240; K2 2.53
// at 20 against 2.84).
constexpr int K1_CHUNK = 10;
constexpr int K2_CHUNK = 20;

struct Lattice {
  const float* f;
  int ni, nj, nk;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One box of the lattice (k, j, i coordinates) into shared memory; the
// bytes are counted on `bar`.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int j, int i) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(k), "r"(j), "r"(i) : "memory");
}

// The same box by 4-byte cp.async copies from the producer warp's 32 lanes
// (zeros outside the lattice); `bar` counts one arrival per lane once that
// lane's copies have landed.
__device__ __forceinline__ void copy_box(float* dst, const Lattice& in,
                                         uint64_t* bar, int k0, int j0, int i,
                                         int rows, int lane) {
  for (int e = lane; e < rows * BOX_K; e += LANES) {
    const int j = j0 + e / BOX_K, k = k0 + e % BOX_K;
    const bool ok = i >= 0 && i < in.ni && j >= 0 && j < in.nj && k >= 0 && k < in.nk;
    const float* src = ok ? in.f + ((size_t)i * in.nj + j) * in.nk + k : in.f;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst + e)), "l"(src), "r"(ok ? 4 : 0) : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The producer: planes q = 0 .. planes - 1 (lattice row i0 + q) of the box
// whose corner is (k0, j0) into stage q % S.
template <int ROWS, int S, bool TMA>
__device__ __forceinline__ void produce(const CUtensorMap* map, const Lattice& in,
                                       float* ring, uint64_t* full, uint64_t* empty,
                                       int k0, int j0, int i0, int planes, int lane) {
  constexpr int STAGE = ROWS * BOX_K;
  if (TMA && lane != 0) return;
  for (int q = 0; q < planes; ++q) {
    const int s = q % S;
    if (q >= S) mbar_wait(&empty[s], ((q / S) - 1) & 1);
    if (TMA) {
      mbar_expect_tx(&full[s], STAGE * 4);
      tma_load(ring + s * STAGE, map, &full[s], k0, j0, i0 + q);
    } else {
      copy_box(ring + s * STAGE, in, &full[s], k0, j0, i0 + q, ROWS, lane);
    }
  }
}

template <int S>
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty,
                                              unsigned fills, unsigned releases) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], fills);
      mbar_init(&empty[s], releases);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ float* align128(unsigned char* p) {
  return reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(p) + 127) & ~uintptr_t(127));
}

// c * (((((im + ip) + jm) + jp) + km) + kp): the reference's order
__device__ __forceinline__ float site(float c, float im, float ip, float jm,
                                      float jp, float km, float kp) {
  float s = im + ip;
  s += jm;
  s += jp;
  s += km;
  s += kp;
  return c * s;
}

// The six-point update of a lane's 4 sites.  b, a: its column below and
// above; u, d: rows j - 1 and j + 1; m: its own 4 sites.  k - 1 of the first
// site and k + 1 of the last come from the neighbouring lanes.
__device__ __forceinline__ float4 stencil4(float c, float4 b, float4 a, float4 u,
                                           float4 d, float4 m) {
  const float kl = __shfl_up_sync(FULL_MASK, m.w, 1);
  const float kr = __shfl_down_sync(FULL_MASK, m.x, 1);
  return make_float4(site(c, b.x, a.x, u.x, d.x, kl, m.y),
                     site(c, b.y, a.y, u.y, d.y, m.x, m.z),
                     site(c, b.z, a.z, u.z, d.z, m.y, m.w),
                     site(c, b.w, a.w, u.w, d.w, m.z, kr));
}

template <bool VEC>
__device__ __forceinline__ void store4(float* p, float4 v, int k, int nk) {
  if (VEC) {
    *reinterpret_cast<float4*>(p) = v;   // nk % 4 == 0: the 4 sites are in or out together
  } else {
    if (k < nk) p[0] = v.x;
    if (k + 1 < nk) p[1] = v.y;
    if (k + 2 < nk) p[2] = v.z;
    if (k + 3 < nk) p[3] = v.w;
  }
}

template <int TJ, int S>
constexpr int k1_smem() { return S * (TJ + 2) * BOX_K * 4 + 2 * S * 8 + 128; }

template <int TJ, int S>
constexpr int k2_smem() {
  return S * (TJ + 4) * BOX_K * 4 + 3 * (TJ + 2) * BOX_K * 4 + 2 * S * 8 + 128;
}

// Output row r (0 <= r < nrows) is the sweep of lattice row row0 + r,
// written to out[r].  Grid: (k tiles, j tiles, i chunks of `chunk` rows);
// TJ + 1 warps, the last the producer.
template <int TJ, int S, int MINB, bool TMA>
__global__ void __launch_bounds__((TJ + 1) * LANES, MINB)
jacobi_sweep_kernel(const __grid_constant__ CUtensorMap map, Lattice in,
                    float* __restrict__ out, int row0, int nrows, int chunk,
                    float c) {
  constexpr int ROWS = TJ + 2;               // box rows j0 - 1 .. j0 + TJ
  constexpr int STAGE = ROWS * BOX_K;
  extern __shared__ unsigned char smem_raw[];
  float* ring = align128(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * STAGE);
  uint64_t* empty = full + S;
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int k0 = blockIdx.x * TK, j0 = blockIdx.y * TJ;
  const int r_begin = blockIdx.z * chunk, r_end = min(r_begin + chunk, nrows);
  const int planes = r_end - r_begin + 2;    // lattice rows row0 + r_begin - 1 ..

  init_barriers<S>(full, empty, TMA ? 1 : LANES, TJ);
  if (warp == TJ) {
    produce<ROWS, S, TMA>(&map, in, ring, full, empty, k0 - 4, j0 - 1,
                          row0 + r_begin - 1, planes, lane);
    return;
  }

  const int j = j0 + warp, k = k0 - 4 + 4 * lane;
  const bool stores = lane >= 1 && lane <= TK / 4 && j < in.nj && k < in.nk;
  const float* col = ring + (warp + 1) * BOX_K + 4 * lane;   // own column, stage 0
  mbar_wait(&full[0], 0);
  float4 below = ld4(col);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[0]);
  mbar_wait(&full[1 % S], (1 / S) & 1);
  float4 cur = ld4(col + (1 % S) * STAGE);
  float* dst = out + ((size_t)r_begin * in.nj + j) * in.nk + k;
  for (int q = 1; q + 1 < planes; ++q) {     // output row r_begin + q - 1
    const int s = q % S, sn = (q + 1) % S;
    mbar_wait(&full[sn], ((q + 1) / S) & 1);
    const float4 above = ld4(col + sn * STAGE);
    const float* pl = ring + s * STAGE + 4 * lane;
    const float4 up = ld4(pl + warp * BOX_K), down = ld4(pl + (warp + 2) * BOX_K);
    const float4 o = stencil4(c, below, above, up, down, cur);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (stores) store4<TMA>(dst, o, k, in.nk);
    dst += (size_t)in.nj * in.nk;
    below = cur;
    cur = above;
  }
}

// Two sweeps per pass over the whole lattice.  Grid as above, over all ni
// rows; TJ + 3 warps: TJ + 2 consumers (step-1 rows j0 - 1 .. j0 + TJ), then
// the producer.  Step-1 plane p needs f planes p - 1 .. p + 1; output row
// p - 1 needs step-1 planes p - 2 .. p.  A chunk [a, b) of output rows reads
// f planes a - 2 .. b + 1 and computes step 1 on planes a - 1 .. b.
template <int TJ, int S, int MINB, bool TMA>
__global__ void __launch_bounds__((TJ + 3) * LANES, MINB)
jacobi_two_step_kernel(const __grid_constant__ CUtensorMap map, Lattice in,
                       float* __restrict__ out, int chunk, float c) {
  constexpr int ROWS = TJ + 4;               // box rows j0 - 2 .. j0 + TJ + 1
  constexpr int STAGE = ROWS * BOX_K;
  constexpr int T_ROWS = TJ + 2;             // step-1 rows j0 - 1 .. j0 + TJ
  constexpr int T_PLANE = T_ROWS * BOX_K;
  constexpr int CONSUMERS = T_ROWS * LANES;
  extern __shared__ unsigned char smem_raw[];
  float* ring = align128(smem_raw);
  float* tring = ring + S * STAGE;           // 3 step-1 planes
  uint64_t* full = reinterpret_cast<uint64_t*>(tring + 3 * T_PLANE);
  uint64_t* empty = full + S;
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int k0 = blockIdx.x * TK, j0 = blockIdx.y * TJ;
  const int a = blockIdx.z * chunk, b = min(a + chunk, in.ni);
  const int planes = b - a + 4;              // f rows a - 2 .. b + 1

  init_barriers<S>(full, empty, TMA ? 1 : LANES, T_ROWS);
  if (warp == T_ROWS) {
    produce<ROWS, S, TMA>(&map, in, ring, full, empty, k0 - 4, j0 - 2, a - 2,
                          planes, lane);
    return;
  }

  const int j = j0 - 1 + warp, k = k0 - 4 + 4 * lane;
  const bool row_in = j >= 0 && j < in.nj;
  const bool k_in[4] = {k >= 0 && k < in.nk, k + 1 >= 0 && k + 1 < in.nk,
                        k + 2 >= 0 && k + 2 < in.nk, k + 3 >= 0 && k + 3 < in.nk};
  const bool outputs = warp >= 1 && warp <= TJ;            // warp-uniform
  const bool stores = outputs && lane >= 1 && lane <= TK / 4 && j < in.nj && k < in.nk;
  const float* col = ring + (warp + 1) * BOX_K + 4 * lane;
  float* tcol = tring + warp * BOX_K + 4 * lane;
  mbar_wait(&full[0], 0);
  float4 f_below = ld4(col);
  __syncwarp();
  if (lane == 0) mbar_arrive(&empty[0]);
  mbar_wait(&full[1 % S], (1 / S) & 1);
  float4 f_cur = ld4(col + (1 % S) * STAGE);
  float4 t_prev2 = make_float4(0.f, 0.f, 0.f, 0.f), t_prev = t_prev2;
  float* dst = out + ((size_t)a * in.nj + j) * in.nk + k;
  for (int q = 1; q + 1 < planes; ++q) {     // step-1 plane p = a - 2 + q
    const int p = a - 2 + q, s = q % S, sn = (q + 1) % S;
    mbar_wait(&full[sn], ((q + 1) / S) & 1);
    const float4 f_above = ld4(col + sn * STAGE);
    const float* pl = ring + s * STAGE + 4 * lane;
    float4 t = stencil4(c, f_below, f_above, ld4(pl + warp * BOX_K),
                        ld4(pl + (warp + 2) * BOX_K), f_cur);
    // Dirichlet at every step: step 1 outside the lattice is zero
    const bool plane_in = row_in && p >= 0 && p < in.ni;
    t.x = plane_in && k_in[0] ? t.x : 0.f;
    t.y = plane_in && k_in[1] ? t.y : 0.f;
    t.z = plane_in && k_in[2] ? t.z : 0.f;
    t.w = plane_in && k_in[3] ? t.w : 0.f;
    *reinterpret_cast<float4*>(tcol + (q % 3) * T_PLANE) = t;
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
    if (outputs && q >= 3) {                 // output row p - 1 from t planes p - 2 .. p
      const float* tp = tring + ((q - 1) % 3) * T_PLANE + 4 * lane;
      const float4 o = stencil4(c, t_prev2, t, ld4(tp + (warp - 1) * BOX_K),
                                ld4(tp + (warp + 1) * BOX_K), t_prev);
      if (stores) store4<TMA>(dst, o, k, in.nk);
      dst += (size_t)in.nj * in.nk;
    }
    t_prev2 = t_prev;
    t_prev = t;
    f_below = f_cur;
    f_cur = f_above;
  }
}

inline unsigned cdiv(int a, int b) { return (unsigned)((a + b - 1) / b); }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Encode failures come back as -(CUresult) - 1000000, apart from cudaError_t.
constexpr int ENCODE_ERROR = -1000000;

int encode_map(CUtensorMap* map, const float* f, int ni, int nj, int nk, int rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)nk, (cuuint64_t)nj, (cuuint64_t)ni};
  const cuuint64_t strides[2] = {(cuuint64_t)nk * 4, (cuuint64_t)nj * nk * 4};
  const cuuint32_t box[3] = {(cuuint32_t)BOX_K, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                              const_cast<float*>(f), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);   // zeros outside
  return res == CUDA_SUCCESS ? 0 : ENCODE_ERROR - (int)res;
}

// One compiled instance: both copy routes of one (TJ, S).
struct Variant {
  int tj, stages, minb, smem;
  const void* tma;
  const void* copy;
};

// MINB: the resident blocks per SM asked of ptxas (__launch_bounds__).
template <int TJ, int S, int MINB = 1>
Variant k1_variant() {
  return {TJ, S, MINB, k1_smem<TJ, S>(),
          reinterpret_cast<const void*>(&jacobi_sweep_kernel<TJ, S, MINB, true>),
          reinterpret_cast<const void*>(&jacobi_sweep_kernel<TJ, S, MINB, false>)};
}

template <int TJ, int S, int MINB = 1>
Variant k2_variant() {
  return {TJ, S, MINB, k2_smem<TJ, S>(),
          reinterpret_cast<const void*>(&jacobi_two_step_kernel<TJ, S, MINB, true>),
          reinterpret_cast<const void*>(&jacobi_two_step_kernel<TJ, S, MINB, false>)};
}

// The candidates `python -m repro_torch.kernels.jacobi.sweep` times; the
// wrappers launch entry K1_DEFAULT / K2_DEFAULT.
const Variant K1_VARIANTS[] = {k1_variant<12, 4>(), k1_variant<12, 6>(),
                               k1_variant<8, 4>(), k1_variant<8, 6>(),
                               k1_variant<16, 4>()};
const Variant K2_VARIANTS[] = {k2_variant<14, 6, 2>(), k2_variant<14, 4, 2>(),
                               k2_variant<8, 6, 3>(), k2_variant<8, 6>(),
                               k2_variant<14, 6>()};
constexpr int K1_DEFAULT = 0, K2_DEFAULT = 0;
constexpr int N_K1 = sizeof(K1_VARIANTS) / sizeof(Variant);
constexpr int N_K2 = sizeof(K2_VARIANTS) / sizeof(Variant);

const Variant* variant(int two_step, int v) {
  if (v < 0 || v >= (two_step ? N_K2 : N_K1)) return nullptr;
  return two_step ? &K2_VARIANTS[v] : &K1_VARIANTS[v];
}

int threads_of(int two_step, const Variant& var) {
  return (var.tj + (two_step ? 3 : 1)) * LANES;
}

// Shared memory past the default 48 KB, and the largest carveout, set once
// per kernel (a launch runs on one host thread at a time: the runtime's
// executor is single-threaded).
cudaError_t prepare(const void* kernel, int smem) {
  static const void* done[2 * (N_K1 + N_K2)];
  static int n_done = 0;
  for (int x = 0; x < n_done; ++x)
    if (done[x] == kernel) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && n_done < 2 * (N_K1 + N_K2)) done[n_done++] = kernel;
  return err;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  if (err <= ENCODE_ERROR) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled returned CUresult %d",
             ENCODE_ERROR - err);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)err);
}

int jacobi_variant_count(int two_step) { return two_step ? N_K2 : N_K1; }

int jacobi_default_variant(int two_step) { return two_step ? K2_DEFAULT : K1_DEFAULT; }

// Rows of an i chunk (a launch over more rows is cut into chunks).
int jacobi_default_chunk(int two_step) { return two_step ? K2_CHUNK : K1_CHUNK; }

// info[0..7] = TJ, TK, stages, threads, dynamic shared memory bytes, the
// resident blocks per SM of the TMA and the 4-byte instance, and the blocks
// per SM asked of ptxas.
int jacobi_variant_info(int two_step, int v, int* info) {
  const Variant* var = variant(two_step, v);
  if (var == nullptr) return (int)cudaErrorInvalidValue;
  info[0] = var->tj;
  info[1] = TK;
  info[2] = var->stages;
  info[3] = threads_of(two_step, *var);
  info[4] = var->smem;
  info[7] = var->minb;
  const void* kernels[2] = {var->tma, var->copy};
  for (int x = 0; x < 2; ++x) {
    cudaError_t err = prepare(kernels[x], var->smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[5 + x], kernels[x],
                                                          info[3], var->smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Rows [row0, row0 + nrows) of one sweep (two_step 0), or two sweeps of the
// whole lattice (two_step 1, row0 = 0, nrows = ni), of the (ni, nj, nk)
// lattice f into out (nrows, nj, nk), both contiguous f32 on the device, by
// instance v in i chunks of `chunk` rows; tma 0 forces the 4-byte copies.
// Launches on `stream` and returns the launch's error (see
// repro_cuda_error_string).
int jacobi_launch(int two_step, int v, int chunk, int tma, const float* f, float* out,
                  int ni, int nj, int nk, int row0, int nrows, float c, void* stream) {
  const Variant* var = variant(two_step, v);
  if (var == nullptr || chunk < 1 || nrows < 1 || ni < 1 || nj < 1 || nk < 1 ||
      row0 < 0 || row0 + nrows > ni || (two_step && (row0 != 0 || nrows != ni)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(nk, TK), cdiv(nj, var->tj), cdiv(nrows, chunk));
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidConfiguration;
  const bool aligned = nk % 4 == 0 && reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const bool use_tma = tma && aligned;
  CUtensorMap map = {};
  if (use_tma) {
    const int err = encode_map(&map, f, ni, nj, nk, var->tj + (two_step ? 4 : 2));
    if (err) return err;
  }
  const void* kernel = use_tma ? var->tma : var->copy;
  cudaError_t err = prepare(kernel, var->smem);
  if (err != cudaSuccess) return (int)err;
  const Lattice in{f, ni, nj, nk};
  void* args_k1[] = {&map, (void*)&in, &out, &row0, &nrows, &chunk, &c};
  void* args_k2[] = {&map, (void*)&in, &out, &chunk, &c};
  err = cudaLaunchKernel(kernel, grid, dim3(threads_of(two_step, *var)),
                         two_step ? args_k2 : args_k1, var->smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The mean host ns of one tensor-map encode for the (ni, nj, nk) lattice at
// f, over `reps` encodes (what encoding per launch costs), into *ns.
// Returns the encode's error (see repro_cuda_error_string).
int jacobi_encode_ns(const float* f, int ni, int nj, int nk, int two_step, int reps,
                     long long* ns) {
  const Variant* var = variant(two_step, two_step ? K2_DEFAULT : K1_DEFAULT);
  CUtensorMap map;
  const int rows = var->tj + (two_step ? 4 : 2);
  int err = encode_map(&map, f, ni, nj, nk, rows);     // resolves the entry point
  const auto t0 = std::chrono::steady_clock::now();
  for (int x = 0; x < reps && !err; ++x) err = encode_map(&map, f, ni, nj, nk, rows);
  const auto t1 = std::chrono::steady_clock::now();
  *ns = std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0).count() /
        (reps > 0 ? reps : 1);
  return err;
}

// The wrappers' entries: the default instance and chunk.
int jacobi_sweep_launch(const float* f, float* out, int ni, int nj, int nk,
                        int row0, int nrows, float c, void* stream) {
  return jacobi_launch(0, K1_DEFAULT, K1_CHUNK, 1, f, out, ni, nj, nk, row0, nrows, c,
                       stream);
}

int jacobi_two_step_launch(const float* f, float* out, int ni, int nj, int nk,
                           float c, void* stream) {
  return jacobi_launch(1, K2_DEFAULT, K2_CHUNK, 1, f, out, ni, nj, nk, 0, ni, c, stream);
}

}  // extern "C"
