// The integer-row scan kernels shared by int8_scan.cu and int4_scan.cu,
// templated on the row format:
//
//   Int8Rows  a corpus row is D int8 values (D bytes); 4 dp4a per 16 bytes
//             against the int8 query.
//   Int4Rows  a corpus row is D/2 packed bytes in the split-half biased
//             layout of semtools_tpu/ops/int4_scan.py: byte j holds element
//             j + 8 (in [0, 15]) in its low nibble and element j + D/2 (in
//             [-8, 7], two's complement) in its high nibble. 8 dp4a per 16
//             bytes: (w & 0x0F0F0F0F) . q_lo gives the biased low half,
//             (w & 0xF0F0F0F0) . q_hi gives 16 x the high half, shifted right
//             by 4 once per 16 bytes (exact: every product is a multiple of
//             16). The sum is the JAX kernels' biased similarity
//             sims_true + 8 * sum(q[:D/2]), a per-query constant shift.
//
// Every similarity is an exact int32 (|sim| < 2^24 at D = 256 for both
// formats), converted to f32 without rounding, so selection is exact and the
// tie rule (value desc, row index asc; common.cuh) holds.
//
// Kernels:
//   sweep_kernel        one pass over the corpus: each query's max similarity
//                       over every SPAN x ROWS-row block (phase 1 of the
//                       two-phase scan at SPAN = 1; the int4 deep-candidate
//                       sweep at SPAN = 4, which also writes every row's
//                       similarity, SIMS = true);
//   rescan_topk_kernel  phase 2 and the merge (topk.cuh, on these formats):
//                       each query's exact top-k of the rows of its chosen
//                       sub-tiles, in one launch.
// With MASKED, rows where the uint8 keep vector is 0 read as -inf; rows >=
// n_true always do.
//
// Sweep layout (the same for both formats): each thread owns one corpus row. The
// block stages ROWS rows x 128 bytes through shared memory at a time, 8
// neighbouring threads reading one row's 128 contiguous bytes in 16-byte
// loads (a padded stride keeps the per-thread 16-byte reads free of bank
// conflicts); the query batch sits in shared memory as packed int32 words for
// the life of the block and is read as warp-wide broadcasts; each thread keeps
// its QB int32 sums in registers. Blocks walk the corpus grid-stride.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "topk.cuh"

namespace semtools {
// Each source that includes this header instantiates its own format only;
// the unnamed namespace keeps every instance private to that source.
namespace {

constexpr int CHUNK_WORDS = 32;                // int32 words (128 bytes) of a row per step
constexpr int STAGE_STRIDE = CHUNK_WORDS + 4;  // padded staged row stride (words)
constexpr int VPR = CHUNK_WORDS / 4;           // 16-byte vectors per staged row chunk

__host__ __device__ inline int round_chunks(int words) {
  return (words + CHUNK_WORDS - 1) / CHUNK_WORDS * CHUNK_WORDS;
}

struct Int8Rows {
  using Query = int;
  using Acc = int;
  // int32 words of one stored row of a width-d model
  __host__ __device__ static int row_words(int d) { return d / 4; }
  __host__ __device__ static int row_vecs(int d) { return d / 16; }
  // int32 words of one int8 query as the caller holds it
  __host__ __device__ static int query_len(int d) { return d / 4; }
  // shared-memory words of one query: whole chunks, zero-filled past d / 4
  __host__ __device__ static int query_words(int d) { return round_chunks(d / 4); }
  __host__ static bool valid_width(int d) { return d > 0 && d % 16 == 0; }
  // word c of the staged query row, from the query's d / 4 int32 words q
  __device__ static int query_word(const int* __restrict__ q, int d, int c) {
    return c < d / 4 ? q[c] : 0;
  }
  // acc + the dot of the 16 stored bytes x (row words w..w+3) with the query qj
  __device__ __forceinline__ static int dot(const int4 x, const int* qj, int w, int dqw, int acc) {
    const int4 y = *reinterpret_cast<const int4*>(qj + w);
    acc = __dp4a(x.x, y.x, acc);
    acc = __dp4a(x.y, y.y, acc);
    acc = __dp4a(x.z, y.z, acc);
    return __dp4a(x.w, y.w, acc);
  }
  // the same for 16-byte vector v of the row (rescan_topk_kernel)
  __device__ __forceinline__ static int vec_dot(const int4 x, const int* qs, int v, int dqw,
                                                int acc) {
    return dot(x, qs, 4 * v, dqw, acc);
  }
  __device__ static float sim(int acc) { return static_cast<float>(acc); }
};

struct Int4Rows {
  using Query = int;
  using Acc = int;
  __host__ __device__ static int row_words(int d) { return d / 8; }
  __host__ __device__ static int row_vecs(int d) { return d / 32; }
  __host__ __device__ static int query_len(int d) { return d / 4; }
  // the query's low half, then its high half, each padded to whole chunks,
  // so word w of a packed row meets query words w and half + w
  __host__ __device__ static int half_words(int d) { return round_chunks(d / 8); }
  __host__ __device__ static int query_words(int d) { return 2 * half_words(d); }
  __host__ static bool valid_width(int d) { return d > 0 && d % 32 == 0; }
  __device__ static int query_word(const int* __restrict__ q, int d, int c) {
    const int half = half_words(d);
    const int h = c / half;
    const int w = c % half;
    return w < d / 8 ? q[h * (d / 8) + w] : 0;
  }
  __device__ __forceinline__ static int dot(const int4 x, const int* qj, int w, int dqw, int acc) {
    constexpr int LO = 0x0F0F0F0F;
    const int4 lo = *reinterpret_cast<const int4*>(qj + w);
    const int4 hi = *reinterpret_cast<const int4*>(qj + dqw / 2 + w);
    acc = __dp4a(x.x & LO, lo.x, acc);
    acc = __dp4a(x.y & LO, lo.y, acc);
    acc = __dp4a(x.z & LO, lo.z, acc);
    acc = __dp4a(x.w & LO, lo.w, acc);
    int h = __dp4a(x.x & ~LO, hi.x, 0);
    h = __dp4a(x.y & ~LO, hi.y, h);
    h = __dp4a(x.z & ~LO, hi.z, h);
    h = __dp4a(x.w & ~LO, hi.w, h);
    return acc + (h >> 4);
  }
  __device__ __forceinline__ static int vec_dot(const int4 x, const int* qs, int v, int dqw,
                                                int acc) {
    return dot(x, qs, 4 * v, dqw, acc);
  }
  __device__ static float sim(int acc) { return static_cast<float>(acc); }
};

// Queries [q_first, q_first + qn) of q8 [*, d] int8 (as d / 4 int32 words
// each) into qs [QB, dqw] in the format's layout, zero-padded.
template <class Fmt, int QB>
__device__ void load_queries(const int* __restrict__ q8, int q_first, int qn, int d, int dqw,
                             int* qs) {
  for (int i = threadIdx.x; i < QB * dqw; i += THREADS) {
    const int j = i / dqw;
    qs[i] = j < qn ? Fmt::query_word(q8 + (long long)(q_first + j) * (d / 4), d, i % dqw) : 0;
  }
}

// Integer sims of rows [row0, row0 + ROWS) (rw int32 words each) against the
// QB queries in qs: thread t gets row row0 + t in acc. Rows >= n_valid read
// as zero.
template <class Fmt, int QB>
__device__ __forceinline__ void block_dots(const int* __restrict__ rows, int rw, long long row0,
                                           long long n_valid, const int* qs, int dqw,
                                           int* stage, int (&acc)[QB]) {
#pragma unroll
  for (int j = 0; j < QB; ++j) acc[j] = 0;
  const int* mine = stage + threadIdx.x * STAGE_STRIDE;
  for (int w0 = 0; w0 < rw; w0 += CHUNK_WORDS) {
    __syncthreads();  // the previous chunk (and the query load) is complete
#pragma unroll
    for (int v = threadIdx.x; v < ROWS * VPR; v += THREADS) {
      const int r = v / VPR;
      const int c = (v % VPR) * 4;
      const long long row = row0 + r;
      int4 x = make_int4(0, 0, 0, 0);
      if (row < n_valid && w0 + c < rw)
        x = __ldg(reinterpret_cast<const int4*>(rows + row * rw + w0 + c));
      *reinterpret_cast<int4*>(stage + r * STAGE_STRIDE + c) = x;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CHUNK_WORDS; c += 4) {
      const int4 x = *reinterpret_cast<const int4*>(mine + c);
#pragma unroll
      for (int j = 0; j < QB; ++j) acc[j] = Fmt::dot(x, qs + j * dqw, w0 + c, dqw, acc[j]);
    }
  }
}

// What one sweep computes: the row format, the mask, the rows per max
// (SPAN x ROWS) and whether every row's similarity is written too.
template <class Fmt, bool MASKED, int SPAN, bool SIMS>
struct Sweep {
  using Rows = Fmt;
  static constexpr bool kMasked = MASKED;
  static constexpr int kSpan = SPAN;
  static constexpr bool kSims = SIMS;
};

// block_max[j, s] = max over the kept rows of block s (SPAN x ROWS rows) of
// query j's integer sim, -inf when the block keeps no row; with kSims also
// sims[j, row] for every row of every block (-inf where not kept). Both
// outputs are row-major with num_blocks (x SPAN x ROWS) columns.
template <class Cfg, int QB>
__global__ void __launch_bounds__(THREADS)
    sweep_kernel(const int* __restrict__ q8, const int* __restrict__ rows,
                 const uint8_t* __restrict__ mask, int qn, int d, long long n_true,
                 long long num_blocks, float* __restrict__ block_max, float* __restrict__ sims) {
  using Fmt = typename Cfg::Rows;
  extern __shared__ int4 smem4[];
  const int dqw = Fmt::query_words(d);
  const int rw = Fmt::row_words(d);
  int* qs = reinterpret_cast<int*>(smem4);
  int* stage = qs + QB * dqw;
  float* red = reinterpret_cast<float*>(stage + ROWS * STAGE_STRIDE);  // [WARPS, QB]
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long sims_ld = num_blocks * Cfg::kSpan * ROWS;
  load_queries<Fmt, QB>(q8, 0, qn, d, dqw, qs);
  for (long long s = blockIdx.x; s < num_blocks; s += gridDim.x) {
    float m[QB];
#pragma unroll
    for (int j = 0; j < QB; ++j) m[j] = -CUDART_INF_F;
#pragma unroll 1
    for (int t = 0; t < Cfg::kSpan; ++t) {
      const long long row0 = (s * Cfg::kSpan + t) * ROWS;
      int acc[QB];
      block_dots<Fmt, QB>(rows, rw, row0, n_true, qs, dqw, stage, acc);
      const long long row = row0 + threadIdx.x;
      const bool valid = keep<Cfg::kMasked>(mask, row, n_true);
#pragma unroll
      for (int j = 0; j < QB; ++j) {
        const float v = valid ? static_cast<float>(acc[j]) : -CUDART_INF_F;
        m[j] = fmaxf(m[j], v);
        if (Cfg::kSims && j < qn) sims[j * sims_ld + row] = v;
      }
    }
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      float v = m[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
      if (lane == 0) red[warp * QB + j] = v;
    }
    __syncthreads();
    if (threadIdx.x < qn) {
      float v = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) v = fmaxf(v, red[w * QB + threadIdx.x]);
      block_max[threadIdx.x * num_blocks + s] = v;
    }
    // The next block_dots starts with a barrier, so red is not rewritten
    // before every reader above is done.
  }
}

template <class Cfg, int QB>
cudaError_t launch_sweep(const int8_t* q8, const int8_t* rows, const uint8_t* mask, int qn, int d,
                         long long n_true, float* block_max, float* sims, long long num_blocks,
                         cudaStream_t stream) {
  using Fmt = typename Cfg::Rows;
  const size_t smem = sizeof(int) * ((size_t)QB * Fmt::query_words(d) + ROWS * STAGE_STRIDE) +
                      sizeof(float) * WARPS * QB;
  static LaunchCache cache;
  auto kernel = sweep_kernel<Cfg, QB>;
  int grid = 0;
  cudaError_t err = cache.prepare(kernel, smem);
  if (err == cudaSuccess) err = cache.grid_for(kernel, smem, num_blocks, &grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(reinterpret_cast<const int*>(q8),
                                          reinterpret_cast<const int*>(rows), mask, qn, d,
                                          n_true, num_blocks, block_max, sims);
  return cudaGetLastError();
}

// Phase 1 of the two-phase scan: out [qn, ceil(n_true / ROWS)].
template <class Fmt>
cudaError_t tilemax(const int8_t* q8, const int8_t* rows, const uint8_t* mask, int qn, int d,
                    long long n_true, float* out, long long num_subs, cudaStream_t s) {
  if (qn < 1 || qn > 32 || !Fmt::valid_width(d) || n_true < 1 ||
      num_subs != (n_true + ROWS - 1) / ROWS)
    return cudaErrorInvalidValue;
  using Plain = Sweep<Fmt, false, 1, false>;
  using Masked = Sweep<Fmt, true, 1, false>;
  return mask != nullptr
             ? SEMTOOLS_BY_QUERIES(launch_sweep, Masked, qn, q8, rows, mask, qn, d, n_true, out,
                                   nullptr, num_subs, s)
             : SEMTOOLS_BY_QUERIES(launch_sweep, Plain, qn, q8, rows, mask, qn, d, n_true, out,
                                   nullptr, num_subs, s);
}

// Phase 2 and the merge: sub_ids [qn, kt] int64 (each query's chosen
// sub-tiles); scratch [qn * kt * ROWS] 64-bit words; out [qn, k], value desc
// then row asc.
template <class Fmt>
cudaError_t rescan_topk(const int8_t* q8, const int8_t* rows, const uint8_t* mask, int qn, int d,
                        long long n_true, const long long* sub_ids, int kt, int k, Key* scratch,
                        float* out_v, long long* out_i, cudaStream_t s) {
  if (!Fmt::valid_width(d) || !valid_rescan(qn, n_true, kt, k)) return cudaErrorInvalidValue;
  return mask != nullptr ? launch_rescan_topk<Fmt, true>(q8, rows, mask, qn, d, n_true, sub_ids,
                                                         kt, k, scratch, out_v, out_i, s)
                         : launch_rescan_topk<Fmt, false>(q8, rows, mask, qn, d, n_true, sub_ids,
                                                          kt, k, scratch, out_v, out_i, s);
}

}  // namespace
}  // namespace semtools
