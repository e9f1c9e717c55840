// The int4 capacity rung of the JAX package's store (semtools_tpu/ops/
// int4_scan.py) for Hopper (sm_90a): scans over a corpus of split-half biased
// int4 rows ([n, D/2] packed bytes, one global scale) against int8 queries.
// The kernels are int_scan.cuh's, instantiated for packed int4 rows.
//
//   int4_sims_max         replaces int4_scan.py:_sims_max_kernel (the
//                         deep-candidate sweep of int4_deep_candidates, every
//                         int4-tier search): one stream over the packed
//                         corpus writes every row's biased integer similarity
//                         [Q, n_pad] (n_pad = 512 * ceil(n_true / 512); -inf
//                         for rows >= n_true) AND each query's max over every
//                         512-row block [Q, n_pad / 512]. 512 is the JAX
//                         package's SUB_N: the candidate extraction ranks
//                         these blocks, and equal blocks give equal candidate
//                         sets when a query has more than the cap.
//   int4_sims_max_masked  replaces _sims_max_kernel_masked (path-subset
//                         serving): rows where the uint8 keep vector is 0 read
//                         as -inf in both outputs.
//   int4_tilemax          replace _tilemax_kernel / _rescan_kernel (the two
//   int4_rescan_topk      phases of int4_topk_scan; the rescan also merges,
//   int4_tilemax_masked   as merge_candidates_sorted did after it) and their
//   int4_rescan_topk_     masked variants _tilemax_kernel_masked /
//     masked              _rescan_kernel_masked, on 128-row sub-tiles (the
//                         exactness argument does not depend on the sub-tile
//                         size). select_subtiles (select.cu) replaces the
//                         lax.top_k between them (:289, :684).
//
// Similarities are exact int32 sums (int_scan.cuh Int4Rows): the biased
// low half (p & 15) . q_lo plus the signed high half (p >> 4) . q_hi, the
// JAX kernels' _int4_sims, |sim| <= 127 * (15 + 8) * D / 2 < 2^24. The
// (1, 8, Q, S) max outputs, the (1, 8, SUB_N) replicated rescan mask and the
// Q % 8 query padding are Mosaic layout workarounds and are not carried over:
// the mask is the store's [capacity] uint8 keep vector and the corpus is
// [capacity, D/2] with no tile padding.
//
// What bounds them on the card: a row is D/2 bytes and costs two dp4a per
// packed word per query (plus a mask and a shift), 4 * Q dp4a per 8 bytes,
// twice the int8 kernels' rate per byte. At Q = 8 that is ~4 dp4a per byte,
// near what the CUDA cores' integer pipe issues at the 3.35 TB/s byte rate,
// so the sweeps may be bound by instruction issue, not by the corpus read;
// int4_sims_max also writes 4 * Q bytes per row (32 B per 128 B read at
// Q = 8). The design keeps the int8 kernels' shape (one read of the corpus in
// coalesced 16-byte loads, queries in shared memory, one row per thread, sums
// in registers), writes the sims in the same pass that takes the block maxima
// (no second pass over the [Q, n_pad] buffer) and shares one 16-byte staged
// vector among all Q queries. Tensor-core (mma.sync / wgmma s8) designs are
// later work; times on the card are in PERF.md.
//
// Interface: plain C entry points (bound with ctypes), each returning the
// cudaError_t of its launch. `mask` may be null (the plain kernels). `d` is
// the model width (the query's int8 length); packed rows are d / 2 bytes and
// must be 16-byte aligned (d % 32 == 0). The caller allocates every output.

#include "int_scan.cuh"

namespace {

using semtools::Int4Rows;
using semtools::ROWS;

constexpr int SIMS_SPAN = 4;  // 128-row steps per 512-row block of int4_sims_max

}  // namespace

extern "C" {

// q8 [qn, d] int8; p4 [>= n_true, d / 2] packed; mask [>= n_true] uint8 or
// null; out [qn, ceil(n_true / ROWS)] f32.
int semtools_int4_tilemax(const int8_t* q8, const int8_t* p4, const uint8_t* mask, int qn, int d,
                          long long n_true, float* out, long long num_subs, void* stream) {
  return static_cast<int>(semtools::tilemax<Int4Rows>(q8, p4, mask, qn, d, n_true, out, num_subs,
                                                      static_cast<cudaStream_t>(stream)));
}

// sub_ids [qn, kt] int64; scratch [qn * kt * ROWS] 64-bit words; out [qn, k]
// (any k up to kt * ROWS: above ROWS every chosen sub-tile is taken whole).
int semtools_int4_rescan_topk(const int8_t* q8, const int8_t* p4, const uint8_t* mask, int qn,
                              int d, long long n_true, const long long* sub_ids, int kt, int k,
                              unsigned long long* scratch, float* out_v, long long* out_i,
                              void* stream) {
  return static_cast<int>(semtools::rescan_topk<Int4Rows>(q8, p4, mask, qn, d, n_true, sub_ids,
                                                          kt, k, scratch, out_v, out_i,
                                                          static_cast<cudaStream_t>(stream)));
}

// Rows per block of int4_sims_max (the JAX package's SUB_N).
int semtools_int4_sims_rows() { return SIMS_SPAN * ROWS; }

// sims [qn, num_blocks * 512] f32 and block_max [qn, num_blocks] f32, both
// row-major and contiguous; num_blocks = ceil(n_true / 512).
int semtools_int4_sims_max(const int8_t* q8, const int8_t* p4, const uint8_t* mask, int qn, int d,
                           long long n_true, float* sims, float* block_max, long long num_blocks,
                           void* stream) {
  constexpr long long span_rows = SIMS_SPAN * ROWS;
  if (qn < 1 || qn > 32 || !Int4Rows::valid_width(d) || n_true < 1 ||
      num_blocks != (n_true + span_rows - 1) / span_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  using Plain = semtools::Sweep<Int4Rows, false, SIMS_SPAN, true>;
  using Masked = semtools::Sweep<Int4Rows, true, SIMS_SPAN, true>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      mask != nullptr
          ? SEMTOOLS_BY_QUERIES(semtools::launch_sweep, Masked, qn, q8, p4, mask, qn, d, n_true,
                                block_max, sims, num_blocks, s)
          : SEMTOOLS_BY_QUERIES(semtools::launch_sweep, Plain, qn, q8, p4, mask, qn, d, n_true,
                                block_max, sims, num_blocks, s);
  return static_cast<int>(err);
}

}  // extern "C"
