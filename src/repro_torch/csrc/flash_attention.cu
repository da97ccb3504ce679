// Hopper (sm_90a) flash attention: GQA, causal with a query offset, sliding
// window, f32 or bf16 in and out, f32 arithmetic.
//
//   flash_attention_kernel  replaces the Pallas kernel `_flash_kernel`
//                           (repro/kernels/flash_attention/kernel.py, reached
//                           through flash_attention).  Same function: query
//                           head h reads kv head h / (Hq/Hkv); key k is seen
//                           by query q when k <= q_offset + q and, with a
//                           window, k > q_offset + q - window; scale hd^-0.5;
//                           online softmax with f32 (m, l, acc); the output
//                           in q's dtype.
//
// What bounds it on an H100.  Prefill is bound by operations: 4*hd flops per
// (query head, query, visible key) pair, for causal attention about
// 4*B*Hq*hd*Tq*Tk/2, over 989 TFLOP/s of bf16 tensor cores (qwen2-0.5b at
// T = 1024: 1.9 GFLOP, 1.9 us).  Decode (Tq = 1) is bound by bytes: the K
// and V rows up to the query's position, over 3.35 TB/s; at qwen2's 2 kv
// heads of 64 that is 512 bytes per position, 0.15 us at position 1000, far
// below the few microseconds a launch costs.  So decode is launch-bound, and
// prefill sits far from its bound until tensor cores do the two products.
//
// Design.  The TPU kernel walks a sequential k grid axis and carries
// (m, l, acc) in VMEM scratch from one grid step to the next.  Here one block
// owns a set of query rows and loops over the k tiles itself, with (m, l,
// acc) in registers:
//   * group-major blocks: a block serves all G = Hq/Hkv query heads of one kv
//     head (qt query positions x G heads, at most 32 rows), so each K/V tile
//     is read once per group, not once per query head as the TPU kernel's
//     index map did.  At decode (one position, G = 7 rows) this is what keeps
//     the K/V bytes at their minimum;
//   * a tile is 32 keys, one per lane: a lane scores its key against a row
//     (16-byte shared-memory loads, the K rows padded so the 32 lanes hit
//     distinct banks), the warp reduces max and sum with shuffles, and each
//     lane then accumulates its own output dims from the V tile;
//   * the next tile is fetched into registers while the current one is
//     computed, so the global loads overlap the arithmetic;
//   * the block computes its own key range: causal blocks stop at their last
//     query's position and windowed blocks start at their first query's
//     window, so decode at position p reads keys 0..p and nothing of the
//     rest of the cache; ragged tile and block edges are masked here, and
//     the caller never pads;
//   * inputs are strided (any b, h, t strides, unit stride along hd), so the
//     model hands over its (B, T, H, hd) projections and (B, S, KV, hd)
//     cache as transposed views, with no copy.
// Head dims 16, 32, 64, 128 and 256 are compiled.  At 256 (gemma3-1b,
// recurrentgemma-9b) a block holds 24,704 floats of q, K and V tiles,
// 98,816 B of dynamic shared memory (opted into above 48 KB), and each
// thread keeps 8 output dims per row and 32 K plus 32 V values in flight.
// Tensor cores (wgmma), TMA and a pipelined tile ring are later work: this
// version is right and simple first.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = 4;
constexpr int MAX_ROWS = WARPS * ROWS_PER_WARP;   // (head, position) rows a block owns
constexpr int BK = 32;                            // keys per tile, one per lane
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
};

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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
constexpr int smem_floats() {
  return MAX_ROWS * HD + BK * (HD + 4) + BK * HD;
}

// Load keys kt0 .. kt0 + BK - 1 of K and V into registers as f32, zero
// past k_end (a zero V row keeps a masked key's 0 * v finite).
template <typename T, int HD, int N>
__device__ __forceinline__ void fetch_tile(const T* kp, const T* vp, long long sk,
                                           long long sv, int kt0, int k_end,
                                           float (&kreg)[N], float (&vreg)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int key = kt0 + e / HD, d = e % HD;
    const bool in = key < k_end;
    kreg[i] = in ? load_f(kp + key * sk + d) : 0.f;
    vreg[i] = in ? load_f(vp + key * sv + d) : 0.f;
  }
}

// Grid: (ceil(tq / qt), hkv, batch).  Row r of a block is query position
// t0 + r / G of query head kvh * G + r % G.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(Args a) {
  constexpr int KS = HD + 4;                      // padded K row (floats)
  constexpr int DPL = (HD + 31) / 32;             // output dims per lane
  constexpr int PER_THREAD = BK * HD / THREADS;   // K (and V) tile elements per thread
  static_assert(BK * HD % THREADS == 0, "tile must split evenly over the block");
  static_assert(HD % 4 == 0, "16-byte shared-memory loads");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                   // [MAX_ROWS][HD], pre-scaled
  float* k_s = q_s + MAX_ROWS * HD;    // [BK][KS]
  float* v_s = k_s + BK * KS;          // [BK][HD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = a.hq / a.hkv;
  const int rows = group * a.qt;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int t0 = blockIdx.x * a.qt;
  const int t1 = min(a.tq, t0 + a.qt);

  const T* q = static_cast<const T*>(a.q) + b * a.sq[0];
  const T* kp = static_cast<const T*>(a.k) + b * a.sk[0] + kvh * a.sk[1];
  const T* vp = static_cast<const T*>(a.v) + b * a.sv[0] + kvh * a.sv[1];
  T* o = static_cast<T*>(a.o) + b * a.so[0];

  // the keys any row of this block can see
  int k_begin = 0, k_end = a.tk;
  if (a.causal) {
    k_end = min(a.tk, a.q_offset + t1);
    if (a.window > 0) k_begin = max(0, a.q_offset + t0 - a.window + 1);
  }

  for (int e = threadIdx.x; e < MAX_ROWS * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    const int t = t0 + r / group, h = kvh * group + r % group;
    float x = 0.f;
    if (r < rows && t < t1) x = load_f(q + h * a.sq[1] + t * a.sq[2] + d) * a.scale;
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

  const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  float kreg[PER_THREAD], vreg[PER_THREAD];
  if (ntiles > 0) fetch_tile<T, HD>(kp, vp, a.sk[2], a.sv[2], k_begin, k_end, kreg, vreg);

  for (int tile = 0; tile < ntiles; ++tile) {
    __syncthreads();   // every warp is done with the previous tile (and q_s is written)
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int j = e / HD, d = e % HD;
      k_s[j * KS + d] = kreg[i];
      v_s[j * HD + d] = vreg[i];
    }
    __syncthreads();
    if (tile + 1 < ntiles)   // in flight while this tile is computed
      fetch_tile<T, HD>(kp, vp, a.sk[2], a.sv[2], k_begin + (tile + 1) * BK, k_end,
                        kreg, vreg);

    const int kt0 = k_begin + tile * BK;
    const int key = kt0 + lane;
    const int nvalid = min(BK, k_end - kt0);
    const float4* krow = reinterpret_cast<const float4*>(k_s + lane * KS);
#pragma unroll
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp + rr * WARPS;            // warp-uniform from here on
      if (r >= rows) break;
      const int t = t0 + r / group;
      if (t >= t1) continue;
      const int qpos = a.q_offset + t;
      bool ok = key < k_end;
      if (a.causal) {
        ok = ok && key <= qpos;
        if (a.window > 0) ok = ok && key > qpos - a.window;
      }
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
    const int r = warp + rr * WARPS;
    if (r >= rows) break;
    const int t = t0 + r / group;
    if (t >= t1) continue;
    const int h = kvh * group + r % group;
    T* orow = o + h * a.so[1] + t * a.so[2];
    const float denom = fmaxf(l[rr], 1e-37f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) store_f(orow + d, acc[rr][i] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<HD>() * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  flash_attention_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, dim3 grid, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, grid, stream);
    case 32: return launch<T, 32>(a, grid, stream);
    case 64: return launch<T, 64>(a, grid, stream);
    case 128: return launch<T, 128>(a, grid, stream);
    case 256: return launch<T, 256>(a, grid, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, (b, h, t) of
// q, k, v and o in that order; the head dim is contiguous in all four.
// Rows a block owns: qt * (hq / hkv) <= 32.  Returns the launch's cudaError_t.
int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                           void* o, int batch, int hq, int hkv, int tq, int tk,
                           int hd, const long long* strides, int causal, int window,
                           int q_offset, float scale, int qt, void* stream) {
  if (batch <= 0 || tq <= 0 || hkv <= 0 || hq % hkv || qt <= 0 ||
      qt * (hq / hkv) > MAX_ROWS || batch > 65535 || hkv > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
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
  dim3 grid((tq + qt - 1) / qt, hkv, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch_hd<float>(hd, a, grid, s)
                  : dtype == 1 ? dispatch_hd<__nv_bfloat16>(hd, a, grid, s)
                               : cudaErrorInvalidValue;
  return (int)err;
}

// Dynamic shared memory one block of head dim hd uses (ptxas reports only
// static shared memory), or -1 for a head dim that is not compiled.
int flash_attention_smem_bytes(int hd) {
  switch (hd) {
    case 16: return smem_floats<16>() * (int)sizeof(float);
    case 32: return smem_floats<32>() * (int)sizeof(float);
    case 64: return smem_floats<64>() * (int)sizeof(float);
    case 128: return smem_floats<128>() * (int)sizeof(float);
    case 256: return smem_floats<256>() * (int)sizeof(float);
    default: return -1;
  }
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
