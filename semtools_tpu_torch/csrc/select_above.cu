// The int4 deep-candidate selection on the card (sm_90a): from the
// deep-candidate sweep's [Q, n_pad] sims and [Q, nb] 512-row block maxima
// (int4_sims_max, int4_scan.cu), each query's cutoff, its counts, and the
// rows at or above the cutoff, with no sort and one host read between them
// (the counts' maxima, which size the extraction: the JAX package's one
// download of the [Q] counts).
//
//   int4_cutoff_counts  replaces the XLA half of _int4_cutoff_counts
//                       (semtools_tpu/ops/int4_scan.py:420-436): the k_cut-th
//                       best sim of the kb best blocks (the lax.top_k over
//                       the gathered blocks, :426; the block ranking, :424,
//                       is select_subtiles, select.cu), the cutoff (that sim
//                       minus the noise margin, -3e38 when it is -inf), the
//                       rows and blocks at or above it, and the marks the
//                       extraction starts from: each block's count of rows
//                       at or above the cutoff, their sums over groups of 256
//                       blocks, and each hit block's 512-bit mask of those
//                       rows. For the sharded tier it also gives a shard's
//                       k_cut best sims (tops), the cutoff of the shards'
//                       merged tops, or the counts and marks against a given
//                       cutoff.
//   int4_extract_above  replaces _extract_above (:439-476): the rows at or
//                       above the cutoff as [Q, cap] int64, the sentinel
//                       n_pad past each query's count. Where a query has
//                       more than cap, the cap best by lax.top_k's order over
//                       its gathered blocks: sim desc, then the block's rank
//                       (max desc, id asc), then the row asc.
//
// Exactness: sims are integers in f32, so every comparison is exact and the
// cutoff is t - margin rounded once, as the plain version computes it. A
// value is compared through its order-preserving bits (topk.cuh ord_bits; -0
// reads as +0, which compares equal in f32 too). The k-th best is a radix
// select over the multiset of those bits (8-bit digits from the top, one
// 256-bin histogram a pass, duplicates counted), so ties need no id. Past
// the cap, the sims above the cap-th value are all taken and the rows equal
// to it are chosen by a second select over 64-bit keys (block max bits above
// the complement of the row: max desc, then block id asc, then row asc,
// since row = block id * 512 + row in the block), so the choice is JAX's.
// The output is deterministic: each block's rows go to the offset that an
// exclusive scan of the per-block counts in block-id order gives it, in
// row order within the block, never to an atomic slot. Under the cap that
// is every row at or above the cutoff in ascending order.
//
// What bounds them on this card: bytes on a dense cutoff, latency at a
// serving one; never operations. A row at or above the cutoff lies in a
// block whose max is at or above it, so only those blocks' sims are read
// (at a serving cutoff a few hundred KB; on random bytes, where the cutoff
// falls into the bulk, half the blocks: 158 MB at 10M rows and Q = 8,
// against the 320 MB of all sims), and the count pass reads them once: it
// is the one pass over the sims after the sweep at or under the cap. The
// cutoff reads kb * 512 sims from L2.
//
// The design: the count pass runs one block of 256 threads per 256 sweep
// blocks over the whole card; it lists its hit blocks (maxima at or above
// the cutoff) in shared memory and its 8 warps take them in turn, each hit's
// 512 sims in four 16-byte loads a lane, two hits in flight. Besides the
// counts (integer atomics per 256 blocks, whose sum does not depend on their
// order) it writes the marks: each block's count, each group's total and
// each hit's mask (16 words; bit j of word w is row 32 w + j), 5.5 MB
// against the 158 MB it reads at that density. The extraction under the cap
// is one launch over the same groups, reading no sim: a block of 256
// threads sums the totals of the groups before its own, scans its 256
// counts, and each thread writes its own block's rows from its mask (at
// this density about 1.5 rows a hit block, so a warp that walked its hits
// one by one spent its time issuing shuffles and scans for empty words).
// Past the cap (only when the host's counts say a
// query is past it) the same kernel first lists every marked row of each
// query in ascending order (32-bit rows), and one block a query runs the
// two selects over its listed rows only (4 + 8 passes, the list read
// coalesced, each row's sim from L2) and writes the chosen rows in list
// order.
//
// Interface: plain C entry points (ctypes), returning the cudaError_t of the
// launch; launch on `stream` and do not synchronise. The caller allocates
// every output and the scratch.

#include "topk.cuh"

namespace {

using semtools::FULL;
using semtools::Key;

constexpr int BLOCK_ROWS = 512;  // rows of a sweep block (int4_scan.cu, the JAX SUB_N)
constexpr int BLOCK_SHIFT = 9;
constexpr int MASK_WORDS = BLOCK_ROWS / 32;  // a block's mask: bit j of word w is row 32 w + j
constexpr int CUT_THREADS = 512;
constexpr int GROUP_THREADS = 256;  // a group: 256 blocks, one a thread, 8 warps of 32
constexpr int GROUP_WARPS = GROUP_THREADS / 32;
constexpr int RULE_THREADS = 1024;
constexpr int ROW_LOADS = 4;  // listed rows a thread of the rule kernel loads per step
constexpr float FEW_ROWS_CUTOFF = -3e38f;  // the cutoff when the k_cut-th best is -inf

struct RadixShared {
  unsigned hist[256];
  Key prefix, mask;  // the digits fixed so far, and which bits they cover
  unsigned need;     // keys still to take among those matching the prefix
  unsigned above;    // keys larger than the prefix found so far
};

struct ScanShared {
  unsigned warp[32];
  unsigned total;
};

__device__ __forceinline__ uint32_t value_bits(float v) { return semtools::ord_bits(v); }

// The k-th largest (1 <= k <= the number of keys) of the multiset of 64-bit
// keys that each_key(f) hands to f (each thread its share), 8-bit digits from
// bit 56 down to bit low_shift (bits below it must be 0). sh.above is then
// the count of keys larger than it.
template <int NT, class EachKey>
__device__ Key kth_largest(EachKey each_key, unsigned k, int low_shift, RadixShared& sh) {
  __syncthreads();  // the caller's reads of the last select are done
  if (threadIdx.x == 0) {
    sh.prefix = 0;
    sh.mask = 0;
    sh.need = k;
    sh.above = 0;
  }
  for (int shift = 56; shift >= low_shift; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += NT) sh.hist[i] = 0;
    __syncthreads();
    const Key prefix = sh.prefix, mask = sh.mask;
    const unsigned need = sh.need;
    each_key([&](Key key) {
      if ((key & mask) == prefix) atomicAdd(&sh.hist[(key >> shift) & 255], 1u);
    });
    __syncthreads();
    if (threadIdx.x < 32) {
      // Lane l holds bins 255 - 8l down to 248 - 8l; find the bin where the
      // count of keys above it first reaches need.
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
      if (above < need && need <= inc) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (above + c[j] >= need) {
            sh.prefix = prefix | (static_cast<Key>(255 - 8 * lane - j) << shift);
            sh.mask = mask | (0xFFull << shift);
            sh.need = need - above;
            sh.above += above;
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
  }
  return sh.prefix;
}

// Exclusive prefix sum of each thread's v in thread order; total = the
// block's sum. Every thread of the block calls it.
template <int NT>
__device__ unsigned block_exclusive_scan(unsigned v, ScanShared& ss, unsigned& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += t;
  }
  if (lane == 31) ss.warp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const unsigned s = lane < NT / 32 ? ss.warp[lane] : 0u;
    unsigned si = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned t = __shfl_up_sync(FULL, si, off);
      if (lane >= off) si += t;
    }
    if (lane < NT / 32) ss.warp[lane] = si - s;
    if (lane == 31) ss.total = si;
  }
  __syncthreads();
  const unsigned out = ss.warp[warp] + inc - v;
  total = ss.total;
  __syncthreads();
  return out;
}

// One block a query. The candidates are the sims of its kb blocks bids[q]
// (in that order) followed by extra[q, 0:n_extra]; t = their k-th best, k =
// min(k_cut, their number). With tops: the k_cut best values (those above t
// in candidate order, then t, then -inf past k). With margin: cutoff[q] =
// t - margin, or FEW_ROWS_CUTOFF when t is -inf. With count: count[q] and
// n_blocks[q] zeroed for the count pass that follows on the stream.
__global__ void __launch_bounds__(CUT_THREADS)
    int4_cutoff_kernel(const float* __restrict__ sims, long long n_pad,
                       const long long* __restrict__ bids, int kb, const float* __restrict__ extra,
                       int n_extra, const float* __restrict__ margin, int k_cut,
                       float* __restrict__ tops, float* __restrict__ cutoff,
                       unsigned long long* __restrict__ count,
                       unsigned long long* __restrict__ n_blocks) {
  __shared__ RadixShared sh;
  __shared__ ScanShared ss;
  constexpr int NT = CUT_THREADS;
  const int q = blockIdx.x;
  if (count != nullptr && threadIdx.x == 0) {
    count[q] = 0;
    n_blocks[q] = 0;
  }
  const float* row = sims + (long long)q * n_pad;
  const long long* qb = bids + (long long)q * kb;
  const float* qe = extra + (long long)q * n_extra;
  const long long from_blocks = (long long)kb * BLOCK_ROWS;
  const long long m = from_blocks + n_extra;
  auto value = [&](long long i) -> float {
    return i < from_blocks ? row[(qb[i >> BLOCK_SHIFT] << BLOCK_SHIFT) + (i & (BLOCK_ROWS - 1))]
                           : qe[i - from_blocks];
  };
  const unsigned k = (unsigned)(k_cut < m ? k_cut : m);
  const Key t = kth_largest<NT>(
      [&](auto f) {
        for (long long i = threadIdx.x; i < m; i += NT) f(static_cast<Key>(value_bits(value(i))) << 32);
      },
      k, 32, sh);
  const uint32_t t_bits = static_cast<uint32_t>(t >> 32);
  const float tv = semtools::from_ord_bits(t_bits);
  const unsigned larger = sh.above;
  if (tops != nullptr) {
    float* out = tops + (long long)q * k_cut;
    unsigned base = 0;
    for (long long i0 = 0; i0 < m; i0 += NT) {
      const long long i = i0 + threadIdx.x;
      const float v = i < m ? value(i) : 0.0f;
      const unsigned take = i < m && value_bits(v) > t_bits;
      unsigned total;
      const unsigned pos = base + block_exclusive_scan<NT>(take, ss, total);
      if (take) out[pos] = v;
      base += total;
    }
    for (int i = (int)larger + threadIdx.x; i < k_cut; i += NT)
      out[i] = i < (int)k ? tv : -CUDART_INF_F;
  }
  if (margin != nullptr && threadIdx.x == 0)
    cutoff[q] = isfinite(tv) ? __fsub_rn(tv, *margin) : FEW_ROWS_CUTOFF;
}

// The marks of one query against its cutoff, filled by the count pass.
struct Marks {
  int* counts;      // [qn, nb]: rows at or above the cutoff, per block
  int* groups;      // [qn, ng]: counts summed over each group of 256 blocks
  unsigned* masks;  // [qn, nb, 16]: which rows (written for blocks with a count only)
};

// Grid (ng = ceil(nb / 256), qn): block x of the grid tests the 256 blocks
// 256 x + t of query q against its cutoff, lists its hits in shared memory,
// and its warps take them in turn (hit i to warp i % 8, two in flight), so
// every warp reads about as many as the others: each hit's 512 sims once,
// its count and mask written; then every block's count, the group's total,
// and the query's rows and hit blocks added to count and n_blocks (zeroed
// before).
__global__ void __launch_bounds__(GROUP_THREADS)
    int4_count_kernel(const float* __restrict__ sims, const float* __restrict__ block_max,
                      long long nb, const float* __restrict__ cutoff,
                      unsigned long long* __restrict__ count,
                      unsigned long long* __restrict__ n_blocks, Marks marks) {
  __shared__ ScanShared ss;
  __shared__ int hit_list[GROUP_THREADS];
  __shared__ unsigned block_rows[GROUP_THREADS];
  const int q = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long g0 = (long long)blockIdx.x * GROUP_THREADS;
  const long long b = g0 + threadIdx.x;
  const float c = cutoff[q];
  const bool hit = b < nb && block_max[(long long)q * nb + b] >= c;
  unsigned n_hit;
  const unsigned slot = block_exclusive_scan<GROUP_THREADS>(hit, ss, n_hit);
  if (hit) hit_list[slot] = threadIdx.x;
  block_rows[threadIdx.x] = 0;
  __syncthreads();
  const float4* qs = reinterpret_cast<const float4*>(sims + (long long)q * nb * BLOCK_ROWS);
  unsigned* qm = marks.masks + (long long)q * nb * MASK_WORDS;
  // A hit's count and mask from its sims, lane l holding rows 128 u + 4 l +
  // e (step u, element e): bits 4 (l % 8) + e of word 4 u + l / 8, gathered
  // over the 8 lanes of a word.
  auto mark = [&](int t, const float4 (&v)[4]) {
    const long long blk = g0 + t;
    unsigned n = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned nib = (v[u].x >= c) | (v[u].y >= c) << 1 | (v[u].z >= c) << 2 |
                           (v[u].w >= c) << 3;
      n += __popc(nib);
      unsigned word = nib << (4 * (lane & 7));
      word |= __shfl_xor_sync(FULL, word, 1);
      word |= __shfl_xor_sync(FULL, word, 2);
      word |= __shfl_xor_sync(FULL, word, 4);
      if ((lane & 7) == 0) qm[blk * MASK_WORDS + 4 * u + (lane >> 3)] = word;
    }
    n = __reduce_add_sync(FULL, n);
    if (lane == 0) block_rows[t] = n;
  };
  for (unsigned i = warp; i < n_hit; i += 2 * GROUP_WARPS) {
    const int t1 = hit_list[i];
    const int t2 = i + GROUP_WARPS < n_hit ? hit_list[i + GROUP_WARPS] : -1;  // warp-uniform
    float4 v1[4], v2[4];
    const float4* p1 = qs + (g0 + t1) * (BLOCK_ROWS / 4) + lane;
#pragma unroll
    for (int u = 0; u < 4; ++u) v1[u] = __ldg(p1 + 32 * u);
    if (t2 >= 0) {
      const float4* p2 = qs + (g0 + t2) * (BLOCK_ROWS / 4) + lane;
#pragma unroll
      for (int u = 0; u < 4; ++u) v2[u] = __ldg(p2 + 32 * u);
    }
    mark(t1, v1);
    if (t2 >= 0) mark(t2, v2);
  }
  __syncthreads();
  const unsigned mine = block_rows[threadIdx.x];
  if (b < nb) marks.counts[(long long)q * nb + b] = (int)mine;
  unsigned group_rows;
  block_exclusive_scan<GROUP_THREADS>(mine, ss, group_rows);
  if (threadIdx.x == 0) {
    marks.groups[(long long)q * gridDim.x + blockIdx.x] = (int)group_rows;
    if (group_rows) atomicAdd(count + q, (unsigned long long)group_rows);
    if (n_hit) atomicAdd(n_blocks + q, (unsigned long long)n_hit);
  }
}

// Grid (ng, qn), one block of the sweep a thread as in the count pass: every
// row the marks mark, in block order then row order, into out [q, 0:count]
// and the sentinel nb * 512 into out [q, count:width] (width >= every
// count). A block's rows start at the exclusive scan of the per-block counts
// in block-id order (the totals of the earlier groups, then this group's 256
// counts); the thread of a block with a count loads its 16 mask words and
// writes its rows itself, bit by bit, with no sim read.
template <class Out>
__global__ void __launch_bounds__(GROUP_THREADS)
    int4_write_kernel(long long nb, const long long* __restrict__ count, long long width,
                      Marks marks, Out* __restrict__ out) {
  __shared__ ScanShared ss;
  constexpr int NT = GROUP_THREADS;
  const int q = blockIdx.y;
  const int* qg = marks.groups + (long long)q * gridDim.x;
  unsigned before = 0;
  for (int i = threadIdx.x; i < (int)blockIdx.x; i += NT) before += (unsigned)qg[i];
  unsigned total;
  block_exclusive_scan<NT>(before, ss, total);
  before = total;
  const long long b = (long long)blockIdx.x * NT + threadIdx.x;
  const unsigned c = b < nb ? (unsigned)marks.counts[(long long)q * nb + b] : 0u;
  unsigned pos = before + block_exclusive_scan<NT>(c, ss, total);
  Out* qo = out + (long long)q * width;
  const long long n = count[q];
  for (long long i = (n < width ? n : width) + b; i < width; i += (long long)gridDim.x * NT)
    qo[i] = static_cast<Out>(nb * BLOCK_ROWS);
  if (c == 0) return;
  const uint4* p =
      reinterpret_cast<const uint4*>(marks.masks + ((long long)q * nb + b) * MASK_WORDS);
  uint4 m[MASK_WORDS / 4];
#pragma unroll
  for (int k = 0; k < MASK_WORDS / 4; ++k) m[k] = __ldg(p + k);
#pragma unroll
  for (int k = 0; k < MASK_WORDS / 4; ++k) {
    const unsigned words[4] = {m[k].x, m[k].y, m[k].z, m[k].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = b * BLOCK_ROWS + 32 * (4 * k + e);
      for (unsigned w = words[e]; w; w &= w - 1) {
        if (pos < width) qo[pos] = static_cast<Out>(r + __ffs(w) - 1);
        ++pos;
      }
    }
  }
}

// One block a query, after int4_write_kernel listed every query's marked
// rows into listing [qn, width] (width >= every count): a query at or under
// the cap copies its first cap entries to out; one past it chooses its cap
// best among them (its cap-th best is at or above the cutoff, so among the
// marked rows) by the two selects, ROW_LOADS listed rows loaded a step, and
// writes them in list order, which is block order then row order.
__global__ void __launch_bounds__(RULE_THREADS)
    int4_rule_kernel(const float* __restrict__ sims, const float* __restrict__ block_max,
                     long long nb, const long long* __restrict__ count, int cap,
                     const unsigned* __restrict__ listing, long long width,
                     long long* __restrict__ out) {
  __shared__ RadixShared sh;
  __shared__ ScanShared ss;
  constexpr int NT = RULE_THREADS;
  const int q = blockIdx.x;
  const long long n = count[q];
  const unsigned* ql = listing + (long long)q * width;
  long long* qo = out + (long long)q * cap;
  if (n <= cap) {
    for (int i = threadIdx.x; i < cap; i += NT) qo[i] = ql[i];
    return;
  }
  const float* qs = sims + (long long)q * nb * BLOCK_ROWS;
  const float* qmax = block_max + (long long)q * nb;
  // f(row, its value bits) for each listed row
  auto each_row = [&](auto f) {
    for (long long i0 = threadIdx.x; i0 < n; i0 += (long long)NT * ROW_LOADS) {
      unsigned r[ROW_LOADS];
      uint32_t vb[ROW_LOADS];
#pragma unroll
      for (int k = 0; k < ROW_LOADS; ++k) r[k] = i0 + k * NT < n ? ql[i0 + k * NT] : 0u;
#pragma unroll
      for (int k = 0; k < ROW_LOADS; ++k) vb[k] = i0 + k * NT < n ? value_bits(qs[r[k]]) : 0u;
#pragma unroll
      for (int k = 0; k < ROW_LOADS; ++k)
        if (i0 + k * NT < n) f(r[k], vb[k]);
    }
  };
  const uint32_t hi = static_cast<uint32_t>(
      kth_largest<NT>(
          [&](auto f) { each_row([&](unsigned, uint32_t v) { f(static_cast<Key>(v) << 32); }); },
          (unsigned)cap, 32, sh) >> 32);
  const unsigned need = (unsigned)cap - sh.above;
  const Key lo = kth_largest<NT>(
      [&](auto f) {
        each_row([&](unsigned r, uint32_t v) {
          if (v == hi) f(semtools::make_key(qmax[r >> BLOCK_SHIFT], r));
        });
      },
      need, 0, sh);
  unsigned base = 0;
  for (long long i0 = 0; i0 < n; i0 += NT) {
    const long long i = i0 + threadIdx.x;
    unsigned take = 0, r = 0;
    if (i < n) {
      r = ql[i];
      const uint32_t v = value_bits(qs[r]);
      take = v > hi || (v == hi && semtools::make_key(qmax[r >> BLOCK_SHIFT], r) >= lo);
    }
    unsigned total;
    const unsigned pos = base + block_exclusive_scan<NT>(take, ss, total);
    if (take && pos < (unsigned)cap) qo[pos] = r;
    base += total;
  }
}

inline bool valid_sweep(int qn, long long nb) {
  return qn >= 1 && qn <= 65535 && nb >= 1 && nb * BLOCK_ROWS < (1LL << 32);
}

inline unsigned num_groups(long long nb) {
  return static_cast<unsigned>((nb + GROUP_THREADS - 1) / GROUP_THREADS);
}

inline bool valid_marks(const int* counts, const int* groups, const unsigned* masks) {
  return counts != nullptr && groups != nullptr && masks != nullptr &&
         reinterpret_cast<uintptr_t>(masks) % 16 == 0;
}

}  // namespace

extern "C" {

// sims [qn, nb * 512] and block_max [qn, nb] f32 (16-byte aligned, as
// int4_sims_max writes them; block_max may be null without count). The
// cutoff kernel runs when kb + n_extra > 0: its candidates are the sims of
// the blocks bids [qn, kb] int64 and extra [qn, n_extra] f32; it writes
// tops [qn, k_cut] when tops is not null and cutoff [qn] when margin (one
// f32 on the card) is not null. The count pass runs when count is not
// null: count and n_blocks [qn] int64 against cutoff [qn] (this launch's or
// the caller's), zeroed first (by the cutoff kernel, else by two memsets),
// and the marks: counts [qn, nb] and groups [qn, ceil(nb / 256)] int32,
// masks [qn, nb, 16] 32-bit words (written for blocks with a count only).
int semtools_int4_cutoff_counts(const float* sims, const float* block_max, int qn, long long nb,
                                const long long* bids, int kb, const float* extra, int n_extra,
                                const float* margin, int k_cut, float* tops, float* cutoff,
                                long long* count, long long* n_blocks, int* counts, int* groups,
                                unsigned* masks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qn < 1 || qn > 65535 || kb < 0 || n_extra < 0 ||
      (cutoff == nullptr && (margin != nullptr || count != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (count != nullptr && (n_blocks == nullptr || block_max == nullptr || !valid_sweep(qn, nb) ||
                           !valid_marks(counts, groups, masks)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* count_u = reinterpret_cast<unsigned long long*>(count);
  auto* n_blocks_u = reinterpret_cast<unsigned long long*>(n_blocks);
  const bool cut = kb + n_extra > 0;
  if (cut) {
    if (k_cut < 1 || (tops == nullptr && margin == nullptr) || (kb > 0 && (bids == nullptr ||
        !valid_sweep(qn, nb) || kb > nb)) || (n_extra > 0 && extra == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    int4_cutoff_kernel<<<qn, CUT_THREADS, 0, st>>>(sims, nb * BLOCK_ROWS, bids, kb, extra, n_extra,
                                                   margin, k_cut, tops, cutoff, count_u,
                                                   n_blocks_u);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (count != nullptr) {
    if (!cut) {
      cudaError_t err = cudaMemsetAsync(count, 0, sizeof(long long) * qn, st);
      if (err == cudaSuccess) err = cudaMemsetAsync(n_blocks, 0, sizeof(long long) * qn, st);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int4_count_kernel<<<dim3(num_groups(nb), qn), GROUP_THREADS, 0, st>>>(
        sims, block_max, nb, cutoff, count_u, n_blocks_u, Marks{counts, groups, masks});
  }
  return static_cast<int>(cudaGetLastError());
}

// count [qn] int64 and the marks counts, groups, masks (int4_cutoff_counts');
// out [qn, cap] int64. With listing null no query may be past the cap: one
// launch, the writes. Else listing is [qn, width] uint32 with width >=
// every count, sims [qn, nb * 512] and block_max [qn, nb] f32 are the
// sweep's, and two launches: every marked row into listing, then each
// query's cap rows out of it.
int semtools_int4_extract_above(const float* sims, const float* block_max, int qn, long long nb,
                                const long long* count, const int* counts, const int* groups,
                                const unsigned* masks, int cap, unsigned* listing,
                                long long width, long long* out, void* stream) {
  if (!valid_sweep(qn, nb) || cap < 1 || count == nullptr || !valid_marks(counts, groups, masks) ||
      out == nullptr || (listing != nullptr && (width < cap || sims == nullptr ||
                                                block_max == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(num_groups(nb), qn);
  const Marks marks{const_cast<int*>(counts), const_cast<int*>(groups),
                    const_cast<unsigned*>(masks)};
  if (listing == nullptr) {
    int4_write_kernel<long long><<<grid, GROUP_THREADS, 0, st>>>(nb, count, cap, marks, out);
  } else {
    int4_write_kernel<unsigned><<<grid, GROUP_THREADS, 0, st>>>(nb, count, width, marks, listing);
    int4_rule_kernel<<<qn, RULE_THREADS, 0, st>>>(sims, block_max, nb, count, cap, listing, width,
                                                  out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
