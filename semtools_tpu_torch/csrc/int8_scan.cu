// Exact top-k over a globally scaled int8 corpus for Hopper (sm_90a): the
// two-phase scan of the JAX package's int8 serving tier
// (semtools_tpu/ops/int8_scan.py), plain and with a per-row keep mask.
//
//   int8_tilemax         replaces int8_scan.py:_tilemax_kernel (phase 1 of
//                        _int8_two_phase): each query's max integer
//                        similarity over every ROWS-row sub-tile.
//   int8_rescan          replaces int8_scan.py:_rescan_kernel (phase 2): for
//                        each (query, chosen sub-tile) pair, that query's
//                        exact top-k of the sub-tile.
//   int8_tilemax_masked  replace _tilemax_kernel_masked / _rescan_kernel_masked
//   int8_rescan_masked   (_int8_two_phase_masked, path-subset serving): the
//                        same with a uint8 keep vector [n_true]; rows where
//                        it is 0 read as -inf in both phases.
//
// Integer similarities are exact: q8 . e8 summed in int32 with __dp4a
// (|sim| <= 127^2 * D, 4,129,024 at D = 256, below 2^24), converted to f32
// without rounding. Selection over them is therefore exact, and so is the
// tie rule (value desc, row index asc; common.cuh). The TPU kernels reach
// the same integers through a bf16 matmul with f32 accumulation; the
// (8, SUB_N) sublane-replicated mask and the (1, 8, Q, S) max output are
// Mosaic layout workarounds and are not carried over: the mask is one byte
// per row and phase 1 writes [Q, ceil(n_true / ROWS)].
//
// What bounds them on the card: bytes. A row is D bytes and costs 2*Q*D
// integer operations, 2*Q per byte: at Q <= 32 that is 64 ops per byte,
// far below the int8 tensor-core ridge (1,979 TOP/s over 3.35 TB/s, ~590
// per byte) and below the dp4a rate of the CUDA cores (four multiply-adds
// per instruction), so the corpus read sets the floor (D * n_true bytes).
//
// What the design does about it (the same shape as fused_scan.cu):
//   * the corpus is read once, in 16-byte vector loads where 8 neighbouring
//     threads read one row's 128 contiguous bytes, staged through shared
//     memory one 128-byte column chunk of ROWS rows at a time (a padded
//     stride keeps the per-thread 16-byte reads free of bank conflicts);
//   * the query batch sits in shared memory as packed int32 words [Q, D/4]
//     for the life of the block, read as warp-wide broadcasts;
//   * each thread owns one corpus row and keeps its Q int32 sums in
//     registers: one staged 16-byte vector feeds 4*Q dp4a instructions;
//   * phase 1 writes Q floats per ROWS rows; phase 2 re-reads Q*k sub-tiles
//     and extracts k rounds inside one warp;
//   * blocks walk the sub-tiles grid-stride, loading the queries once.
// mma.sync / wgmma with s8.s8 -> s32 and TMA staging are later work; times
// on the card are in PERF.md.
//
// Interface: plain C entry points (bound with ctypes), each returning the
// cudaError_t of its launch. `mask` may be null (the plain kernels). Rows
// must be 16-byte aligned (D % 16 == 0). The caller allocates every output.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace {

using semtools::FULL;
using semtools::ROWS;
using semtools::THREADS;
using semtools::WARPS;
using semtools::grid_for;
using semtools::prepare;
using semtools::warp_topk;

constexpr int CHUNK_WORDS = 32;          // int32 words (128 bytes) of each row per step
constexpr int STAGE_STRIDE = CHUNK_WORDS + 4;  // padded staged row stride (words)
constexpr int VPR = CHUNK_WORDS / 4;     // 16-byte vectors per staged row chunk

// Padded query stride in words: whole chunks, zero-filled past D / 4.
__host__ __device__ inline int query_words(int d) {
  return (d / 4 + CHUNK_WORDS - 1) / CHUNK_WORDS * CHUNK_WORDS;
}

// Queries [q_first, q_first + qn) of q8 [*, d] into qs [QB, dqw] as packed
// int32 words, zero-padded.
template <int QB>
__device__ void load_queries(const int* __restrict__ q8, int q_first, int qn, int dw, int dqw,
                             int* qs) {
  for (int i = threadIdx.x; i < QB * dqw; i += THREADS) {
    const int j = i / dqw;
    const int c = i % dqw;
    qs[i] = (j < qn && c < dw) ? q8[(long long)(q_first + j) * dw + c] : 0;
  }
}

// Integer sims of rows [row0, row0 + ROWS) against the QB queries in qs:
// thread t gets row row0 + t in acc. Rows >= n_valid read as zero.
template <int QB>
__device__ __forceinline__ void block_dots(const int* __restrict__ e8, int dw, long long row0,
                                           long long n_valid, const int* qs, int dqw,
                                           int* stage, int (&acc)[QB]) {
#pragma unroll
  for (int j = 0; j < QB; ++j) acc[j] = 0;
  const int* mine = stage + threadIdx.x * STAGE_STRIDE;
  for (int w0 = 0; w0 < dw; w0 += CHUNK_WORDS) {
    __syncthreads();  // the previous chunk (and the query load) is complete
#pragma unroll
    for (int v = threadIdx.x; v < ROWS * VPR; v += THREADS) {
      const int r = v / VPR;
      const int c = (v % VPR) * 4;
      const long long row = row0 + r;
      int4 x = make_int4(0, 0, 0, 0);
      if (row < n_valid && w0 + c < dw)
        x = __ldg(reinterpret_cast<const int4*>(e8 + row * dw + w0 + c));
      *reinterpret_cast<int4*>(stage + r * STAGE_STRIDE + c) = x;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CHUNK_WORDS; c += 4) {
      const int4 x = *reinterpret_cast<const int4*>(mine + c);
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        const int4 y = *reinterpret_cast<const int4*>(qs + j * dqw + w0 + c);
        int a = acc[j];
        a = __dp4a(x.x, y.x, a);
        a = __dp4a(x.y, y.y, a);
        a = __dp4a(x.z, y.z, a);
        a = __dp4a(x.w, y.w, a);
        acc[j] = a;
      }
    }
  }
}

template <bool MASKED>
__device__ __forceinline__ bool keep(const uint8_t* __restrict__ mask, long long row,
                                     long long n_true) {
  return row < n_true && (!MASKED || mask[row] != 0);
}

// Phase 1: sub_max[j, s] = max over kept rows of sub-tile s of the integer
// sim of query j; -inf when the sub-tile keeps no row.
template <bool MASKED, int QB>
__global__ void __launch_bounds__(THREADS)
    tilemax_kernel(const int* __restrict__ q8, const int* __restrict__ e8,
                   const uint8_t* __restrict__ mask, int qn, int dw, long long n_true,
                   long long num_subs, float* __restrict__ sub_max) {
  extern __shared__ int4 smem4[];
  const int dqw = query_words(dw * 4);
  int* qs = reinterpret_cast<int*>(smem4);
  int* stage = qs + QB * dqw;
  float* red = reinterpret_cast<float*>(stage + ROWS * STAGE_STRIDE);  // [WARPS, QB]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  load_queries<QB>(q8, 0, qn, dw, dqw, qs);
  for (long long s = blockIdx.x; s < num_subs; s += gridDim.x) {
    const long long row0 = s * ROWS;
    int acc[QB];
    block_dots<QB>(e8, dw, row0, n_true, qs, dqw, stage, acc);
    const bool valid = keep<MASKED>(mask, row0 + threadIdx.x, n_true);
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      float m = valid ? static_cast<float>(acc[j]) : -CUDART_INF_F;
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

// Phase 2: block b rescans sub-tile sub_ids[b] for its owner query
// b / k_tiles and writes that query's top-k of the kept rows (-inf filler
// at the positions of rows not kept when fewer than k are).
template <bool MASKED>
__global__ void __launch_bounds__(THREADS)
    rescan_kernel(const int* __restrict__ q8, const int* __restrict__ e8,
                  const uint8_t* __restrict__ mask, int dw, long long n_true,
                  const long long* __restrict__ sub_ids, int k_tiles, int k,
                  float* __restrict__ out_v, long long* __restrict__ out_i) {
  extern __shared__ int4 smem4[];
  const int dqw = query_words(dw * 4);
  int* qs = reinterpret_cast<int*>(smem4);
  int* stage = qs + dqw;
  float* sims = reinterpret_cast<float*>(stage + ROWS * STAGE_STRIDE);  // [ROWS]
  const int b = blockIdx.x;
  const long long row0 = sub_ids[b] * ROWS;
  load_queries<1>(q8, b / k_tiles, 1, dw, dqw, qs);
  int acc[1];
  block_dots<1>(e8, dw, row0, n_true, qs, dqw, stage, acc);
  sims[threadIdx.x] = keep<MASKED>(mask, row0 + threadIdx.x, n_true)
                          ? static_cast<float>(acc[0]) : -CUDART_INF_F;
  __syncthreads();
  if (threadIdx.x < 32) warp_topk(sims, k, row0, out_v + (long long)b * k, out_i + (long long)b * k);
}

template <bool MASKED, int QB>
cudaError_t launch_tilemax(const int8_t* q8, const int8_t* e8, const uint8_t* mask, int qn,
                           int d, long long n_true, float* out, long long num_subs,
                           cudaStream_t stream) {
  const size_t smem = sizeof(int) * ((size_t)QB * query_words(d) + ROWS * STAGE_STRIDE) +
                      sizeof(float) * WARPS * QB;
  auto kernel = tilemax_kernel<MASKED, QB>;
  int grid = 0;
  cudaError_t err = prepare(kernel, smem);
  if (err == cudaSuccess) err = grid_for(kernel, smem, num_subs, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(reinterpret_cast<const int*>(q8),
                                          reinterpret_cast<const int*>(e8), mask, qn, d / 4,
                                          n_true, num_subs, out);
  return cudaGetLastError();
}

template <bool MASKED>
cudaError_t launch_rescan(const int8_t* q8, const int8_t* e8, const uint8_t* mask, int d,
                          long long n_true, const long long* sub_ids, int n_pairs, int k_tiles,
                          int k, float* out_v, long long* out_i, cudaStream_t stream) {
  const size_t smem =
      sizeof(int) * ((size_t)query_words(d) + ROWS * STAGE_STRIDE) + sizeof(float) * ROWS;
  auto kernel = rescan_kernel<MASKED>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_pairs, THREADS, smem, stream>>>(reinterpret_cast<const int*>(q8),
                                             reinterpret_cast<const int*>(e8), mask, d / 4,
                                             n_true, sub_ids, k_tiles, k, out_v, out_i);
  return cudaGetLastError();
}

bool valid_args(int qn, int d, long long n_true) {
  return qn >= 1 && qn <= 32 && d > 0 && d % 16 == 0 && n_true > 0;
}

}  // namespace

extern "C" {

// q8 [qn, d] int8; e8 [>= n_true, d] int8; mask [>= n_true] uint8 or null;
// out [qn, num_subs] f32, num_subs = ceil(n_true / ROWS).
int semtools_int8_tilemax(const int8_t* q8, const int8_t* e8, const uint8_t* mask, int qn, int d,
                          long long n_true, float* out, long long num_subs, void* stream) {
  if (!valid_args(qn, d, n_true) || num_subs != (n_true + ROWS - 1) / ROWS)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      mask != nullptr
          ? SEMTOOLS_BY_QUERIES(launch_tilemax, true, qn, q8, e8, mask, qn, d, n_true, out,
                                num_subs, s)
          : SEMTOOLS_BY_QUERIES(launch_tilemax, false, qn, q8, e8, mask, qn, d, n_true, out,
                                num_subs, s);
  return static_cast<int>(err);
}

// sub_ids [qn * k_tiles] int64, query-major; out [qn * k_tiles, k].
int semtools_int8_rescan(const int8_t* q8, const int8_t* e8, const uint8_t* mask, int qn, int d,
                         long long n_true, const long long* sub_ids, int k_tiles, int k,
                         float* out_v, long long* out_i, void* stream) {
  if (!valid_args(qn, d, n_true) || k_tiles < 1 || k < 1 || k > ROWS)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_pairs = qn * k_tiles;
  const cudaError_t err =
      mask != nullptr ? launch_rescan<true>(q8, e8, mask, d, n_true, sub_ids, n_pairs, k_tiles,
                                            k, out_v, out_i, s)
                      : launch_rescan<false>(q8, e8, mask, d, n_true, sub_ids, n_pairs, k_tiles,
                                             k, out_v, out_i, s);
  return static_cast<int>(err);
}

}  // extern "C"
