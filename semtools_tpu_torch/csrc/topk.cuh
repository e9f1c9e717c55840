// Exact top-k selection inside a block, and the block-to-block merge that
// finishes a query's selection in the launch that made its candidates.
// Shared by the sub-tile selection (select.cu) and the phase-2 rescans
// (rescan_topk_kernel below, instantiated by fused_scan.cu, int8_scan.cu and
// int4_scan.cu for their row formats).
//
// Order (exactness, see KERNELS.md "Two-phase kernel"): value desc, then id
// asc, the tie rule of lax.top_k and of the stable sorts of the plain
// versions. Each candidate is one 64-bit key, the order-preserving bits of
// its f32 value above the complement of its 32-bit id, so that one unsigned
// comparison is the whole rule and every key of a query is distinct.
//
// Selection (block_select): with at most one key per thread, each key's
// rank among all of them, in one pass. With more, a radix select: 8-bit
// digits from the top, a 256-bin histogram per pass in shared memory,
// stopping at the first digit whose bin holds exactly the keys still wanted
// (ties run on into the id bits); only keys at or above a floor (the k-th
// largest of the threads' maxima) are counted, a few dozen of the thousands
// a chunk holds. The k keys at or above the threshold are then compacted
// and ordered by rank (k^2 / threads comparisons, shared-memory broadcasts).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (select_subtiles, Q = 8,
// 78,119 sub-tile maxima, k = 10, device time): 15.6 us counting every key
// into the histogram, 43 us with warp-aggregated increments
// (__match_any_sync), 14.2 us with the floor; PERF.md has the rest.
//
// rescan_topk_kernel (phase 2 and the merge, one launch) replaces the
// Pallas rescan kernels and the XLA merge after them: pallas_scan.py
// _rescan_kernel (:293-318) + merge_candidates_sorted (:389), and their
// twins int8_scan.py _rescan_kernel / _rescan_kernel_masked (:133, :236;
// merges :214, :334) and int4_scan.py _rescan_kernel /
// _rescan_kernel_masked (:232, :624; merges :314 and after :684). The
// sub-tiles it reads come from select.cu, which replaces the lax.top_k
// between the phases (:362 and the twins).
//
// What bounds it on this card: latency, then bytes. It reads Q * kt
// sub-tiles of 128 rows (10 MB for f32 at Q = 8, k = 10: 3 us at 3.35 TB/s;
// 2.6 MB int8, 1.3 MB int4) and does 2 * D operations per row; the old
// design ran one 128-thread block per (query, sub-tile) pair, fewer blocks
// than SMs at CLI sizes, each a chain of dependent steps (query load,
// staged 128-byte chunks with two barriers each, k rounds of a one-warp
// top-k while three warps waited), and left a [Q, kt, k] candidate tensor
// to a torch sort and gathers.
//
// What the design does about it: every load a thread will need is issued
// before any sum (g = 8 lanes per row read its 128-byte lines, up to
// MAX_LOADS 16-byte loads in flight per thread), and an f32 sub-tile is
// split over 4 blocks (bf16 over 2), so one round trip to memory fills the
// sims; all four warps sum, select and rank; each block keeps its best
// min(k, rows) keys and the last block of each query (ticket) selects the
// query's k from them (read once into shared memory when there are at most
// MERGE_KEYS), so the answer [Q, k] is written by the same launch and
// nothing goes back to torch. A thread-block cluster per query (merging
// through distributed shared memory) would cap a query at 8 blocks (16
// non-portable); at Q = 1, k = 10 the f32 rescan runs 40 blocks for it.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "common.cuh"

namespace semtools {
namespace {

using Key = unsigned long long;

// As unsigned integers, these compare as the floats do; -0 reads as +0.
__device__ __forceinline__ uint32_t ord_bits(float v) {
  uint32_t b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_ord_bits(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ Key make_key(float v, long long id) {
  return (static_cast<Key>(ord_bits(v)) << 32) | static_cast<uint32_t>(~static_cast<uint32_t>(id));
}

__device__ __forceinline__ float key_value(Key key) { return from_ord_bits(static_cast<uint32_t>(key >> 32)); }

__device__ __forceinline__ long long key_id(Key key) {
  return static_cast<long long>(~static_cast<uint32_t>(key));
}

constexpr int MAX_BLOCK = 256;  // threads of the largest block that selects

struct TopkShared {
  unsigned hist[256];
  Key tmax[MAX_BLOCK];  // each thread's largest key
  Key floor;            // no key below it is among the k largest
  Key prefix, mask;     // the digits fixed so far, and which bits they cover
  unsigned need;        // keys still to take among those matching the prefix
  unsigned count;
  int done;
  int last;
};

// The min(k, m) largest of the m distinct keys load(0..m) into sel, in no
// order; returns how many. load(i) reads shared or global memory.
template <int NT, typename Load>
__device__ int block_select(Load load, int m, int k, Key* sel, TopkShared& sh) {
  if (k >= m) {
    for (int i = threadIdx.x; i < m; i += NT) sel[i] = load(i);
    __syncthreads();
    return m;
  }
  if (m <= NT) {  // a key per thread: its rank among all, in one pass
    if (threadIdx.x < m) {
      const Key key = load(threadIdx.x);
      int rank = 0;
      for (int j = 0; j < m; ++j) rank += load(j) > key;
      if (rank < k) sel[rank] = key;
    }
    __syncthreads();
    return k;
  }
  static_assert(NT <= MAX_BLOCK, "TopkShared holds one maximum per thread");
  // The floor: the k-th largest of the threads' maxima (each thread holds a
  // key here, m > NT, and they are distinct). k keys are at or above it, so
  // the k largest are too, and only the keys at or above it (at most
  // k * ceil(m / NT), a few dozen where m is thousands) take part below.
  // Keys of one digit would otherwise all add to one histogram bin, and
  // floats of one magnitude share their top digits.
  Key tmax = 0;
  for (int i = threadIdx.x; i < m; i += NT) {
    const Key key = load(i);
    tmax = key > tmax ? key : tmax;
  }
  sh.tmax[threadIdx.x] = tmax;
  if (threadIdx.x == 0) {
    sh.floor = 0;
    sh.prefix = 0;
    sh.mask = 0;
    sh.need = k;
    sh.done = 0;
  }
  __syncthreads();
  if (k <= NT) {
    int rank = 0;
    for (int j = 0; j < NT; ++j) rank += sh.tmax[j] > tmax;
    if (rank == k - 1) sh.floor = tmax;
  }
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += NT) sh.hist[i] = 0;
    __syncthreads();
    const Key floor = sh.floor, prefix = sh.prefix, mask = sh.mask;
    for (int i = threadIdx.x; i < m; i += NT) {
      const Key key = load(i);
      if (key >= floor && (key & mask) == prefix) atomicAdd(&sh.hist[(key >> shift) & 255], 1u);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      // Lane l holds bins 255 - 8l down to 248 - 8l; find the bin where the
      // count of keys above it first reaches sh.need.
      const int lane = threadIdx.x;
      unsigned c[8], s = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = sh.hist[255 - 8 * lane - j];
        s += c[j];
      }
      unsigned inc = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(FULL, inc, off);
        if (lane >= off) inc += t;
      }
      unsigned above = inc - s;
      const unsigned need = sh.need;
      if (above < need && need <= inc) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above + c[j] >= need) {
            sh.prefix = prefix | (static_cast<Key>(255 - 8 * lane - j) << shift);
            sh.mask = mask | (0xFFull << shift);
            sh.need = need - above;
            sh.done = c[j] == need - above;
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
    if (sh.done) break;
  }
  // Every key at or above the floor whose fixed digits are at or above the
  // prefix is taken.
  const Key floor = sh.floor, prefix = sh.prefix, mask = sh.mask;
  if (threadIdx.x == 0) sh.count = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += NT) {
    const Key key = load(i);
    if (key >= floor && (key & mask) >= prefix) {
      const unsigned slot = atomicAdd(&sh.count, 1u);
      if (slot < static_cast<unsigned>(k)) sel[slot] = key;
    }
  }
  __syncthreads();
  return k;
}

// dst[0, m) = load(0..m), LOAD_BATCH independent loads in flight per thread
// (a plain loop would wait out one memory round trip per iteration).
constexpr int LOAD_BATCH = 16;

template <int NT, typename Load, typename Store>
__device__ __forceinline__ void batched_copy(Load load, int m, Store store) {
  for (int base = 0; base < m; base += NT * LOAD_BATCH) {
    decltype(load(0)) v[LOAD_BATCH];
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int i = base + u * NT + threadIdx.x;
      if (i < m) v[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < LOAD_BATCH; ++u) {
      const int i = base + u * NT + threadIdx.x;
      if (i < m) store(i, v[u]);
    }
  }
}

// The k best of the m candidate keys the blocks of one query left in
// global memory (all), into sel: read once into shared memory (buf, room
// for cap keys) when they fit, else selected where they lie in L2.
template <int NT>
__device__ void merge_select(const Key* all, int m, int k, Key* buf, int cap, Key* sel,
                             TopkShared& sh) {
  if (m <= cap) {
    batched_copy<NT>([&](int i) { return __ldcg(all + i); }, m,
                     [&](int i, Key key) { buf[i] = key; });
    __syncthreads();
    block_select<NT>([&](int i) { return buf[i]; }, m, k, sel, sh);
  } else {
    block_select<NT>([&](int i) { return __ldcg(all + i); }, m, k, sel, sh);
  }
}

// emit(rank, key) for each of the n distinct keys of sel, rank 0 the largest.
template <int NT, typename Emit>
__device__ void block_rank(const Key* sel, int n, Emit emit) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const Key key = sel[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += sel[j] > key;
    emit(rank, key);
  }
}

// Each launch's blocks of one query draw a ticket after writing their
// candidates; the block drawing the last one merges. Launches of one source's
// kernels share these counters, so they must be ordered (the port launches
// on one stream), and the merging block sets its query's counter back to 0.
constexpr int MAX_QUERIES = 32;
__device__ unsigned tickets[MAX_QUERIES] = {};

// True in the block that finishes query q's nblocks blocks; its reads of
// the other blocks' candidates (through __ldcg) see their writes.
__device__ bool last_of_query(int q, int nblocks, TopkShared& sh) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sh.last = atomicAdd(&tickets[q], 1u) == static_cast<unsigned>(nblocks - 1);
  __syncthreads();
  if (sh.last) __threadfence();
  return sh.last;
}

__device__ void release_ticket(int q) {
  if (threadIdx.x == 0) tickets[q] = 0;
}

// 16-byte loads a rescan thread issues before it sums them.
constexpr int MAX_LOADS = 16;
// Candidate keys the merging block of a rescan holds in shared memory.
constexpr int MERGE_KEYS = 4096;

// Lanes that share one row (a power of two, at most 8, at most the row's
// 16-byte vectors), so a group's loads cover whole 128-byte lines.
__host__ __device__ inline int lanes_per_row(int row_vecs) {
  int g = 8;
  while (g > row_vecs) g >>= 1;
  return g;
}

// Blocks per sub-tile: the fewest (a power of two) that keep each thread's
// 16-byte loads of its rows within MAX_LOADS, so they are issued at once.
__host__ inline int rescan_split(int row_vecs) {
  const int g = lanes_per_row(row_vecs);
  const int per_lane = (row_vecs + g - 1) / g;
  int split = 1;
  // steps of THREADS / g rows: ROWS / split * g / THREADS (ROWS == THREADS)
  while (split < g && g / split * per_lane > MAX_LOADS) split <<= 1;
  return split;
}

// Phase 2 of the two-phase scan, rescan and merge in one launch. Block
// (p, j) computes query j's similarity to rows_per_block rows of its
// chosen sub-tile sub_ids[j, p / split] (part p % split), keeps their best
// min(k, rows_per_block) as keys in scratch, and the last of query j's
// kt * split blocks selects the query's k best of all of them:
// out_v/out_i [qn, k], value desc then row asc. Rows >= n_true, and with
// MASKED rows whose keep byte is 0, read as -inf (filler rows then rank by
// row, as the stable sorts of the plain versions give them).
//
// Fmt: the row format. row_vecs(d) 16-byte vectors per row, Query the
// type of a shared-memory query word, query_words(d) / query_len(d) its
// length in shared memory / in the caller's query, query_word(q, d, c),
// Acc, vec_dot(x, qs, v, dqw, acc) the partial dot of vector v, and
// sim(acc) the f32 similarity of a finished sum.
template <class Fmt, bool MASKED>
__global__ void __launch_bounds__(THREADS)
    rescan_topk_kernel(const typename Fmt::Query* __restrict__ q, const int4* __restrict__ rows,
                       const uint8_t* __restrict__ mask, int d, long long n_true,
                       const long long* __restrict__ sub_ids, int kt, int split, int k,
                       int kcap, Key* __restrict__ scratch, float* __restrict__ out_v,
                       long long* __restrict__ out_i) {
  using Query = typename Fmt::Query;
  using Acc = typename Fmt::Acc;
  extern __shared__ int4 smem4[];
  __shared__ TopkShared sh;
  const int j = blockIdx.y;
  const int p = blockIdx.x;
  const int rpb = ROWS / split;  // rows of this block
  const int dqw = Fmt::query_words(d);
  const int rv = Fmt::row_vecs(d);
  Query* qs = reinterpret_cast<Query*>(smem4);      // [dqw], whole 128-byte chunks
  Key* keys = reinterpret_cast<Key*>(qs + dqw);     // [kcap >= rpb]
  Key* sel = keys + kcap;                           // [k]
  const long long row0 = sub_ids[(long long)j * kt + p / split] * ROWS + (long long)(p % split) * rpb;

  const Query* qj = q + (long long)j * Fmt::query_len(d);
  batched_copy<THREADS>([&](int c) { return Fmt::query_word(qj, d, c); }, dqw,
                        [&](int c, Query w) { qs[c] = w; });

  // g lanes per row, THREADS / g rows per step; lane l of a group holds
  // vectors l, l + g, ... of its row. Every load is issued before the sums.
  const int g = lanes_per_row(rv);
  const int per_lane = (rv + g - 1) / g;
  const int rows_per_step = THREADS / g;
  const int steps = (rpb + rows_per_step - 1) / rows_per_step;
  const int lg = threadIdx.x % g;
  const int rr = threadIdx.x / g;
  const int nv = steps * per_lane;
  __syncthreads();
  int st = 0, jv = 0;
  Acc acc = 0;
  for (int base = 0; base < nv; base += MAX_LOADS) {
    int4 buf[MAX_LOADS];
    int lst = st, ljv = jv;
#pragma unroll
    for (int i = 0; i < MAX_LOADS; ++i) {
      const int r = lst * rows_per_step + rr;
      const int v = lg + ljv * g;
      const long long row = row0 + r;
      buf[i] = make_int4(0, 0, 0, 0);
      if (base + i < nv && r < rpb && v < rv && row < n_true) buf[i] = __ldg(rows + row * rv + v);
      if (++ljv == per_lane) {
        ljv = 0;
        ++lst;
      }
    }
#pragma unroll
    for (int i = 0; i < MAX_LOADS; ++i) {
      if (base + i < nv) {
        acc = Fmt::vec_dot(buf[i], qs, lg + jv * g, dqw, acc);
        if (++jv == per_lane) {  // the same in every lane of the warp
          for (int off = g / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
          const int r = st * rows_per_step + rr;
          const long long row = row0 + r;
          if (lg == 0 && r < rpb) {
            const float s = keep<MASKED>(mask, row, n_true) ? Fmt::sim(acc) : -CUDART_INF_F;
            keys[r] = make_key(s, row);
          }
          acc = 0;
          jv = 0;
          ++st;
        }
      }
    }
  }
  __syncthreads();

  const int nblocks = kt * split;
  const int kl = k < rpb ? k : rpb;
  if (nblocks == 1) {  // one block holds the whole query: rank it here
    block_select<THREADS>([&](int i) { return keys[i]; }, rpb, k, sel, sh);
  } else {
    const int got = block_select<THREADS>([&](int i) { return keys[i]; }, rpb, kl, sel, sh);
    Key* mine = scratch + ((long long)j * nblocks + p) * kl;
    for (int i = threadIdx.x; i < got; i += THREADS) mine[i] = sel[i];
    if (!last_of_query(j, nblocks, sh)) return;
    merge_select<THREADS>(scratch + (long long)j * nblocks * kl, nblocks * kl, k, keys, kcap, sel,
                          sh);
    release_ticket(j);
  }
  block_rank<THREADS>(sel, k, [&](int r, Key key) {
    out_v[(long long)j * k + r] = key_value(key);
    out_i[(long long)j * k + r] = key_id(key);
  });
}

template <class Fmt, bool MASKED>
cudaError_t launch_rescan_topk(const void* q, const void* rows, const uint8_t* mask, int qn, int d,
                               long long n_true, const long long* sub_ids, int kt, int k,
                               Key* scratch, float* out_v, long long* out_i, cudaStream_t stream) {
  static LaunchCache cache;
  const int split = rescan_split(Fmt::row_vecs(d));
  const int rpb = ROWS / split;
  // the merging block reads the query's candidates into shared memory
  // when they take at most MERGE_KEYS (32 KB)
  const int merged = kt * split * (k < rpb ? k : rpb);
  const int kcap = merged <= MERGE_KEYS && merged > rpb ? merged : rpb;
  const size_t smem =
      sizeof(typename Fmt::Query) * Fmt::query_words(d) + sizeof(Key) * ((size_t)kcap + k);
  auto kernel = rescan_topk_kernel<Fmt, MASKED>;
  const cudaError_t err = cache.prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(kt * split, qn), THREADS, smem, stream>>>(
      static_cast<const typename Fmt::Query*>(q), static_cast<const int4*>(rows), mask, d, n_true,
      sub_ids, kt, split, k, kcap, scratch, out_v, out_i);
  return cudaGetLastError();
}

// Most keys a query's selection holds in shared memory (its k).
constexpr int MAX_SELECT = 16384;

// The checks every two-phase rescan entry makes; row ids live in 32 bits.
inline bool valid_rescan(int qn, long long n_true, int kt, int k) {
  return qn >= 1 && qn <= MAX_QUERIES && n_true >= 1 && n_true < (1LL << 32) && kt >= 1 &&
         k >= 1 && k <= MAX_SELECT && (long long)kt * ROWS >= k;
}

}  // namespace
}  // namespace semtools
