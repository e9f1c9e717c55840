// Fused cosine scan + exact top-k selection for Hopper (sm_90a).
//
// Three kernels, one per Pallas kernel body of the JAX package's fused scan
// (semtools_tpu/ops/pallas_scan.py):
//
//   fused_tilemax          replaces pallas_scan.py:_tilemax_kernel (phase 1 of
//                          _two_phase_topk): each query's max similarity over
//                          every SUB-row sub-tile of the corpus.
//   fused_rescan_topk      replaces pallas_scan.py:_rescan_kernel (phase 2,
//                          :293-318) and the merge after it
//                          (merge_candidates_sorted, :389): for each query, its
//                          sims over the rows of its chosen sub-tiles and
//                          their exact top-k, in one launch (topk.cuh
//                          rescan_topk_kernel on f32/bf16 rows, FloatRows
//                          below). The sub-tiles come from select_subtiles
//                          (select.cu), which replaces the lax.top_k at :362.
//   fused_scan_candidates  replaces pallas_scan.py:_scan_kernel (single
//                          phase, _pallas_candidates): each tile's exact
//                          top-k for every query.
//
// What bounds them on the card: bytes. A corpus row of D f32 values is 4*D
// bytes and costs 2*Q*D flops, Q/2 flops per byte (Q per byte in bf16). The
// H100's ridge point for CUDA-core f32 is 67 TFLOP/s over 3.35 TB/s, about
// 20 flops per byte, so for f32 at the routing limit Q <= 32 the scan is
// bound by the corpus read (the FMA rate close behind at Q = 32; bf16 at
// Q = 32, 32 flops per byte, is bound by the FMAs). The reference scores
// f32 at HIGHEST precision, so the sums are f32 FMAs on the CUDA cores (no
// TF32 tensor-core path, which keeps ~3 decimal digits). The rescan reads
// Q*k sub-tiles (10 MB at Q = 8, k = 10, 3 us at 3.35 TB/s): it is bound by
// how many of those bytes are in flight at once, which topk.cuh's design
// addresses (every row load of a thread issued before the sums, four blocks
// per f32 sub-tile).
//
// What the sweeps' design does about it:
//   * the corpus is read once, in row-major 16-byte vector loads where
//     neighbouring threads read neighbouring addresses (each row chunk is 128
//     contiguous bytes), staged through shared memory one 128-byte column
//     chunk of ROWS rows at a time;
//   * the queries sit in shared memory for the life of the block (Q*D*4
//     bytes: 32 KB at Q = 32, D = 256) and are read as warp-wide broadcasts;
//   * each thread owns one corpus row and keeps its Q partial sums in
//     registers, so one staged float4 feeds 4*Q FMAs;
//   * selection never leaves the chip: phase 1 writes Q floats per SUB rows
//     (Q*N/32 bytes next to the 4*N*D-byte corpus read), the single-phase
//     selection is a warp-level k-round (max, earliest index, mask out) over
//     ROWS values;
//   * blocks walk the sub-tiles grid-stride, so the queries are loaded once
//     per block rather than once per sub-tile.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (2M x 256
// f32 corpus, Q = 8, k = 10, CUDA events): fused_tilemax 0.80 ms, a corpus
// read of 2.56 TB/s, against 1.34 ms for its plain PyTorch version; the
// other kernels' times are in PERF.md. wgmma, TMA and a cp.async pipeline
// are later work.
//
// Sizes: ROWS = 128 rows per block step = one sub-tile (phase 1 and 2) and
// one tile (single phase). 128 threads each own one row; the per-block
// shared memory (staging 18 KB f32 / 35 KB bf16, plus the queries) leaves
// room for several blocks per SM to keep loads in flight. A 128-row
// sub-tile keeps the phase-2 re-read at Q*k*128 rows (0.5% of a 2M-row
// corpus at Q = 8, k = 10) and the phase-1 output at Q*N/128 floats.
//
// Tie rule (exactness, see KERNELS.md "Two-phase kernel"): candidates are
// ordered by (value desc, row index asc) (common.cuh, topk.cuh).
//
// Interface: plain C entry points (bound with ctypes). Each returns the
// cudaError_t of its launch as an int; it launches on the given stream and
// does not synchronise. The caller allocates every output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "topk.cuh"

namespace {

using semtools::FULL;
using semtools::LaunchCache;
using semtools::ROWS;
using semtools::THREADS;
using semtools::WARPS;
using semtools::warp_topk;

constexpr int CHUNK_BYTES = 128;   // bytes of each row staged per step
constexpr int PAD = 4;             // floats of padding per staged row

// One 16-byte load of corpus elements, widened to f32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const int4 v, float* out) {
    out[0] = __int_as_float(v.x);
    out[1] = __int_as_float(v.y);
    out[2] = __int_as_float(v.z);
    out[3] = __int_as_float(v.w);
  }
  __device__ __forceinline__ static void load(const float* p, float* out) {
    widen(__ldg(reinterpret_cast<const int4*>(p)), out);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const int4 v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    widen(__ldg(reinterpret_cast<const int4*>(p)), out);
  }
};

template <typename T>
struct Layout {
  static constexpr int DC = CHUNK_BYTES / sizeof(T);  // elements staged per row
  static constexpr int SS = DC + PAD;                 // staged row stride (floats)
  // Padded query stride: whole chunks, zero-filled past D.
  __host__ __device__ static int dq(int d) { return (d + DC - 1) / DC * DC; }
};

// Queries [q_first, q_first + qn) of q [*, d] into qs [QB, dq], zero-padded.
template <int QB>
__device__ void load_queries(const float* __restrict__ q, int q_first, int qn, int d,
                             int dq, float* qs) {
  for (int i = threadIdx.x; i < QB * dq; i += THREADS) {
    const int j = i / dq;
    const int c = i % dq;
    qs[i] = (j < qn && c < d) ? q[(long long)(q_first + j) * d + c] : 0.f;
  }
}

// f32 / bf16 rows for topk.cuh's rescan_topk_kernel: the query in shared
// memory as f32 (zero-padded to whole staged chunks), one 16-byte vector of
// the row widened to f32 and multiplied into an f32 sum.
template <typename T>
struct FloatRows {
  using Query = float;
  using Acc = float;
  __host__ __device__ static int row_vecs(int d) { return d * (int)sizeof(T) / 16; }
  __host__ __device__ static int query_words(int d) { return Layout<T>::dq(d); }
  __host__ __device__ static int query_len(int d) { return d; }
  __device__ static float query_word(const float* __restrict__ q, int d, int c) {
    return c < d ? q[c] : 0.f;
  }
  __device__ __forceinline__ static float vec_dot(const int4 x, const float* qs, int v, int,
                                                  float acc) {
    constexpr int V = Vec<T>::N;
    float f[V];
    Vec<T>::widen(x, f);
    const float* y = qs + v * V;
#pragma unroll
    for (int i = 0; i < V; ++i) acc = fmaf(f[i], y[i], acc);
    return acc;
  }
  __device__ static float sim(float acc) { return acc; }
};

// Sims of rows [row0, row0 + ROWS) against the QB queries in qs: thread t
// gets row row0 + t in acc. Rows >= n_valid read as zero (callers mask).
template <typename T, int QB>
__device__ __forceinline__ void block_dots(const T* __restrict__ e, int d, long long row0,
                                           long long n_valid, const float* qs, int dq,
                                           float* stage, float (&acc)[QB]) {
  constexpr int V = Vec<T>::N;
  constexpr int DC = Layout<T>::DC;
  constexpr int SS = Layout<T>::SS;
  constexpr int VPR = DC / V;  // 16-byte vectors per staged row chunk
#pragma unroll
  for (int j = 0; j < QB; ++j) acc[j] = 0.f;
  const float* mine = stage + threadIdx.x * SS;
  for (int d0 = 0; d0 < d; d0 += DC) {
    __syncthreads();  // the previous chunk (and the query load) is complete
#pragma unroll
    for (int v = threadIdx.x; v < ROWS * VPR; v += THREADS) {
      const int r = v / VPR;
      const int c = (v % VPR) * V;
      const long long row = row0 + r;
      float buf[V];
      if (row < n_valid && d0 + c < d) {
        Vec<T>::load(e + row * d + d0 + c, buf);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) buf[i] = 0.f;
      }
      float* dst = stage + r * SS + c;
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(dst + i) = make_float4(buf[i], buf[i + 1], buf[i + 2], buf[i + 3]);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < DC; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(mine + c);
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        const float4 y = *reinterpret_cast<const float4*>(qs + j * dq + d0 + c);
        float a = acc[j];
        a = fmaf(x.x, y.x, a);
        a = fmaf(x.y, y.y, a);
        a = fmaf(x.z, y.z, a);
        a = fmaf(x.w, y.w, a);
        acc[j] = a;
      }
    }
  }
}

// Phase 1: sub_max[j, s] = max over rows of sub-tile s of sim(query j, row),
// rows >= n_true reading as -inf. num_subs = ceil(n_true / ROWS).
template <typename T, int QB>
__global__ void __launch_bounds__(THREADS)
    tilemax_kernel(const float* __restrict__ q, const T* __restrict__ e, int qn, int d,
                   long long n_true, long long num_subs, float* __restrict__ sub_max) {
  extern __shared__ float4 smem4[];
  const int dq = Layout<T>::dq(d);
  float* qs = reinterpret_cast<float*>(smem4);
  float* stage = qs + QB * dq;
  float* red = stage + ROWS * Layout<T>::SS;  // [WARPS, QB]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  load_queries<QB>(q, 0, qn, d, dq, qs);
  for (long long s = blockIdx.x; s < num_subs; s += gridDim.x) {
    const long long row0 = s * ROWS;
    float acc[QB];
    block_dots<T, QB>(e, d, row0, n_true, qs, dq, stage, acc);
    const bool valid = row0 + threadIdx.x < n_true;
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      float m = valid ? acc[j] : -CUDART_INF_F;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
      if (lane == 0) red[warp * QB + j] = m;
    }
    __syncthreads();
    if (threadIdx.x < qn) {
      float m = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w * QB + threadIdx.x]);
      sub_max[threadIdx.x * num_subs + s] = m;
    }
    // The next block_dots starts with a barrier, so red is not rewritten
    // before every reader above is done.
  }
}

// Single phase: for each ROWS-row tile t, every query's top-k of the tile,
// written to out[t, j, :]. num_tiles = ceil(n_true / ROWS).
template <typename T, int QB>
__global__ void __launch_bounds__(THREADS)
    scan_kernel(const float* __restrict__ q, const T* __restrict__ e, int qn, int d,
                long long n_true, long long num_tiles, int k, float* __restrict__ out_v,
                long long* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  const int dq = Layout<T>::dq(d);
  float* qs = reinterpret_cast<float*>(smem4);
  float* stage = qs + QB * dq;
  float* sims = stage + ROWS * Layout<T>::SS;  // [QB, ROWS]
  const int warp = threadIdx.x >> 5;
  load_queries<QB>(q, 0, qn, d, dq, qs);
  for (long long t = blockIdx.x; t < num_tiles; t += gridDim.x) {
    const long long row0 = t * ROWS;
    float acc[QB];
    block_dots<T, QB>(e, d, row0, n_true, qs, dq, stage, acc);
    const bool valid = row0 + threadIdx.x < n_true;
#pragma unroll
    for (int j = 0; j < QB; ++j) sims[j * ROWS + threadIdx.x] = valid ? acc[j] : -CUDART_INF_F;
    __syncthreads();
    for (int j = warp; j < qn; j += WARPS) {
      const long long o = (t * qn + j) * k;
      warp_topk(sims + j * ROWS, k, row0, out_v + o, out_i + o);
    }
    // The next block_dots starts with a barrier before sims is rewritten.
  }
}

template <typename T, int QB>
cudaError_t launch_tilemax(const float* q, const void* e, int qn, int d, long long n_true,
                           float* out, long long num_subs, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)QB * Layout<T>::dq(d) + ROWS * Layout<T>::SS + WARPS * QB);
  static LaunchCache cache;
  auto kernel = tilemax_kernel<T, QB>;
  int grid = 0;
  cudaError_t err = cache.prepare(kernel, smem);
  if (err == cudaSuccess) err = cache.grid_for(kernel, smem, num_subs, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(q, static_cast<const T*>(e), qn, d, n_true, num_subs, out);
  return cudaGetLastError();
}

template <typename T, int QB>
cudaError_t launch_scan(const float* q, const void* e, int qn, int d, long long n_true,
                        long long num_tiles, int k, float* out_v, long long* out_i,
                        cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)QB * Layout<T>::dq(d) + ROWS * Layout<T>::SS + QB * ROWS);
  static LaunchCache cache;
  auto kernel = scan_kernel<T, QB>;
  int grid = 0;
  cudaError_t err = cache.prepare(kernel, smem);
  if (err == cudaSuccess) err = cache.grid_for(kernel, smem, num_tiles, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(q, static_cast<const T*>(e), qn, d, n_true, num_tiles,
                                          k, out_v, out_i);
  return cudaGetLastError();
}

enum Dtype { kF32 = 0, kBF16 = 1 };

bool valid_args(int dtype, int qn, int d, long long n_true) {
  return (dtype == kF32 || dtype == kBF16) && qn >= 1 && qn <= 32 && d > 0 && n_true > 0;
}

}  // namespace

extern "C" {

int semtools_scan_rows() { return ROWS; }

const char* semtools_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}


// q [qn, d] f32; e [>= n_true, d] f32 or bf16; out [qn, num_subs] f32.
int semtools_fused_tilemax(const float* q, const void* e, int dtype, int qn, int d,
                           long long n_true, float* out, long long num_subs, void* stream) {
  if (!valid_args(dtype, qn, d, n_true) || num_subs != (n_true + ROWS - 1) / ROWS)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kF32
          ? SEMTOOLS_BY_QUERIES(launch_tilemax, float, qn, q, e, qn, d, n_true, out, num_subs, s)
          : SEMTOOLS_BY_QUERIES(launch_tilemax, __nv_bfloat16, qn, q, e, qn, d, n_true, out,
                                num_subs, s);
  return static_cast<int>(err);
}

// sub_ids [qn, kt] int64 (each query's chosen sub-tiles); scratch
// [qn * kt * ROWS] 64-bit words; out [qn, k], value desc then row asc.
int semtools_fused_rescan_topk(const float* q, const void* e, int dtype, int qn, int d,
                               long long n_true, const long long* sub_ids, int kt, int k,
                               unsigned long long* scratch, float* out_v, long long* out_i,
                               void* stream) {
  const int item = dtype == kF32 ? 4 : 2;
  if (!valid_args(dtype, qn, d, n_true) || (d * item) % 16 ||
      !semtools::valid_rescan(qn, n_true, kt, k))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kF32
          ? semtools::launch_rescan_topk<FloatRows<float>, false>(
                q, e, nullptr, qn, d, n_true, sub_ids, kt, k, scratch, out_v, out_i, s)
          : semtools::launch_rescan_topk<FloatRows<__nv_bfloat16>, false>(
                q, e, nullptr, qn, d, n_true, sub_ids, kt, k, scratch, out_v, out_i, s);
  return static_cast<int>(err);
}

// out [num_tiles, qn, k]; num_tiles = ceil(n_true / ROWS).
int semtools_fused_scan_candidates(const float* q, const void* e, int dtype, int qn, int d,
                                   long long n_true, int k, float* out_v, long long* out_i,
                                   long long num_tiles, void* stream) {
  if (!valid_args(dtype, qn, d, n_true) || k < 1 || k > ROWS ||
      num_tiles != (n_true + ROWS - 1) / ROWS)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kF32 ? SEMTOOLS_BY_QUERIES(launch_scan, float, qn, q, e, qn, d, n_true, num_tiles,
                                          k, out_v, out_i, s)
                    : SEMTOOLS_BY_QUERIES(launch_scan, __nv_bfloat16, qn, q, e, qn, d, n_true,
                                          num_tiles, k, out_v, out_i, s);
  return static_cast<int>(err);
}

}  // extern "C"
