// Exact top-k over a globally scaled int8 corpus for Hopper (sm_90a): the
// two-phase scan of the JAX package's int8 serving tier
// (semtools_tpu/ops/int8_scan.py), plain and with a per-row keep mask. The
// kernels are int_scan.cuh's, instantiated for int8 rows.
//
//   int8_tilemax         replaces int8_scan.py:_tilemax_kernel (phase 1 of
//                        _int8_two_phase): each query's max integer
//                        similarity over every ROWS-row sub-tile.
//   int8_rescan_topk     replaces int8_scan.py:_rescan_kernel (phase 2) and
//                        the merge after it (merge_candidates_sorted at
//                        :214): each query's exact top-k of the rows of its
//                        chosen sub-tiles, in one launch (topk.cuh). The
//                        sub-tiles come from select_subtiles (select.cu),
//                        which replaces the lax.top_k at :188 and :301.
//   int8_tilemax_masked  replace _tilemax_kernel_masked / _rescan_kernel_masked
//   int8_rescan_topk_    (_int8_two_phase_masked, path-subset serving): the
//     masked             same with a uint8 keep vector [n_true]; rows where
//                        it is 0 read as -inf in both phases.
//
// Integer similarities are exact: q8 . e8 summed in int32 with __dp4a
// (|sim| <= 127^2 * D, 4,129,024 at D = 256, below 2^24), converted to f32
// without rounding. The TPU kernels reach the same integers through a bf16
// matmul with f32 accumulation; the (8, SUB_N) sublane-replicated mask and
// the (1, 8, Q, S) max output are Mosaic layout workarounds and are not
// carried over: the mask is one byte per row and phase 1 writes
// [Q, ceil(n_true / ROWS)].
//
// What bounds them on the card: bytes. A row is D bytes and costs 2*Q*D
// integer operations, 2*Q per byte: at Q <= 32 that is 64 ops per byte,
// far below the int8 tensor-core ridge (1,979 TOP/s over 3.35 TB/s, ~590
// per byte) and below the dp4a rate of the CUDA cores (four multiply-adds
// per instruction), so the corpus read sets the floor (D * n_true bytes).
// The design (one corpus read, staged through shared memory in coalesced
// 16-byte loads, queries resident in shared memory, one row per thread) is
// described in int_scan.cuh. mma.sync / wgmma with s8.s8 -> s32 and TMA
// staging are later work; times on the card are in PERF.md.
//
// Interface: plain C entry points (bound with ctypes), each returning the
// cudaError_t of its launch. `mask` may be null (the plain kernels). Rows
// must be 16-byte aligned (D % 16 == 0). The caller allocates every output.

#include "int_scan.cuh"

extern "C" {

// q8 [qn, d] int8; e8 [>= n_true, d] int8; mask [>= n_true] uint8 or null;
// out [qn, num_subs] f32, num_subs = ceil(n_true / ROWS).
int semtools_int8_tilemax(const int8_t* q8, const int8_t* e8, const uint8_t* mask, int qn, int d,
                          long long n_true, float* out, long long num_subs, void* stream) {
  return static_cast<int>(semtools::tilemax<semtools::Int8Rows>(
      q8, e8, mask, qn, d, n_true, out, num_subs, static_cast<cudaStream_t>(stream)));
}

// sub_ids [qn, kt] int64; scratch [qn * kt * ROWS] 64-bit words; out [qn, k].
int semtools_int8_rescan_topk(const int8_t* q8, const int8_t* e8, const uint8_t* mask, int qn,
                              int d, long long n_true, const long long* sub_ids, int kt, int k,
                              unsigned long long* scratch, float* out_v, long long* out_i,
                              void* stream) {
  return static_cast<int>(semtools::rescan_topk<semtools::Int8Rows>(
      q8, e8, mask, qn, d, n_true, sub_ids, kt, k, scratch, out_v, out_i,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
