// Sub-tile selection of the two-phase scans on the card (sm_90a), for every
// row format: from phase 1's [qn, s] sub-tile maxima, each query's kt best
// sub-tiles, ordered by max desc then sub-tile id asc (KERNELS.md
// "Two-phase kernel": the lower sub-tile wins a tie, which is what makes the
// scan exact; -inf maxima of empty or masked sub-tiles still rank by id).
//
//   select_subtiles  replaces the XLA step between the Pallas phases:
//                    lax.top_k over the transposed phase-1 maxima at
//                    semtools_tpu/ops/pallas_scan.py:362 (_two_phase_topk),
//                    ops/int8_scan.py:188, 301 and ops/int4_scan.py:289, 684
//                    (the int8 / int4 two-phase scans, plain and masked).
//
// What bounds it on this card: neither bytes nor operations. It reads
// 4 * qn * s bytes once (312 KB a query at 10M rows) and does a few integer
// operations per value: 0.1 us of HBM time at Q = 8, 10M rows. What it
// costs is latency: one launch, one round trip to memory, a few barriers.
//
// What the design does about it: the row is cut into chunks of `chunk`
// maxima, one 256-thread block each (grid chunks x qn), so the read is
// spread over the card and each value is read from memory once into shared
// memory. A block keeps its chunk's kt best (a radix select, topk.cuh) as
// 64-bit (value, id) keys in scratch; the last block of each query to
// finish (a ticket, topk.cuh) selects the kt best of those and writes them
// in order. A query of one chunk is ranked by its only block.
//
// Also here: the launch floor (an empty kernel through the same ctypes path).
//
// Interface: plain C entry points (ctypes), returning the cudaError_t of the
// launch; launches on `stream` and does not synchronise.

#include "topk.cuh"

namespace {

using semtools::Key;
using semtools::TopkShared;

constexpr int SELECT_THREADS = 256;

__global__ void __launch_bounds__(SELECT_THREADS)
    select_kernel(const float* __restrict__ sub_max, long long s, int kt, int chunk,
                  Key* __restrict__ scratch, long long* __restrict__ out_ids) {
  extern __shared__ int4 smem4[];
  __shared__ TopkShared sh;
  constexpr int NT = SELECT_THREADS;
  const int q = blockIdx.y;
  const int c = blockIdx.x;
  const int nchunks = gridDim.x;
  const long long c0 = (long long)c * chunk;
  const int len = (int)(s - c0 < chunk ? s - c0 : chunk);
  Key* keys = reinterpret_cast<Key*>(smem4);  // [chunk]
  Key* sel = keys + chunk;                    // [kt]
  const float* row = sub_max + (long long)q * s + c0;
  semtools::batched_copy<NT>([&](int i) { return __ldg(row + i); }, len,
                             [&](int i, float v) { keys[i] = semtools::make_key(v, c0 + i); });
  __syncthreads();

  const int kc = kt < chunk ? kt : chunk;  // keys each chunk passes on
  if (nchunks > 1) {
    const int got = semtools::block_select<NT>([&](int i) { return keys[i]; }, len, kc, sel, sh);
    Key* mine = scratch + ((long long)q * nchunks + c) * kc;
    for (int i = threadIdx.x; i < kc; i += NT) mine[i] = i < got ? sel[i] : 0ull;  // 0: below all
    if (!semtools::last_of_query(q, nchunks, sh)) return;
    semtools::merge_select<NT>(scratch + (long long)q * nchunks * kc, nchunks * kc, kt, keys, chunk,
                               sel, sh);
    semtools::release_ticket(q);
  } else {
    semtools::block_select<NT>([&](int i) { return keys[i]; }, len, kt, sel, sh);
  }
  semtools::block_rank<NT>(sel, kt, [&](int r, Key key) {
    out_ids[(long long)q * kt + r] = semtools::key_id(key);
  });
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// sub_max [qn, s] f32 (row-major, contiguous); out_ids [qn, kt] int64;
// scratch [qn, ceil(s / chunk), min(kt, chunk)] 64-bit words (unused, and
// may be null, when s <= chunk).
int semtools_select_subtiles(const float* sub_max, int qn, long long s, int kt, int chunk,
                             long long* out_ids, unsigned long long* scratch, void* stream) {
  if (qn < 1 || qn > semtools::MAX_QUERIES || s < 1 || s >= (1LL << 32) || kt < 1 || kt > s ||
      kt > semtools::MAX_SELECT || chunk < 1 || chunk > 8192)
    return static_cast<int>(cudaErrorInvalidValue);
  static semtools::LaunchCache cache;
  if (chunk > s) chunk = (int)s;
  const long long nchunks = (s + chunk - 1) / chunk;
  if (nchunks > 1 && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(Key) * ((size_t)chunk + kt);
  cudaError_t err = cache.prepare(select_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<<<dim3((unsigned)nchunks, qn), SELECT_THREADS, smem,
                  static_cast<cudaStream_t>(stream)>>>(sub_max, s, kt, chunk, scratch, out_ids);
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel through the same ctypes path as the scan
// kernels: the launch floor their times are read against.
int semtools_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
