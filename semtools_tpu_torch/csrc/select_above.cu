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
//                       rows and blocks at or above it. For the sharded tier
//                       it also gives a shard's k_cut best sims (tops), the
//                       cutoff of the shards' merged tops, or the counts
//                       against a given cutoff.
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
// row order within the block, never to an atomic slot.
//
// What bounds them on this card: latency at a serving cutoff, bytes on a
// dense one; never operations. A row at
// or above the cutoff lies in a block whose max is at or above it, so the
// kernels read the [Q, nb] maxima (78 KB a query at 10M rows) and only those
// blocks' sims, not the 320 MB of sims at 10M rows and Q = 8 (at a serving
// cutoff a few hundred KB; on random bytes, where the cutoff falls into the
// bulk, half the blocks). The cutoff reads kb * 512 sims from L2. The
// design: every pass over the blocks runs one warp per 32 blocks over the
// whole card (a ballot of the maxima, then each hit block's 512 sims in
// four 16-byte loads a lane): the counts (integer atomics per warp, whose
// sum does not depend on their order), and the extraction's per-block
// counts and writes. What is serial runs one block per query on small
// inputs: the cutoff's select, the extraction's rule (past the cap, two
// selects over the candidate blocks' rows, 4 + 8 passes) and the
// block-id-order scan of the per-block counts that places each block's rows.
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
constexpr int CUT_THREADS = 512;
constexpr int COUNT_THREADS = 256;  // 8 warps, 32 blocks a warp
constexpr int EXTRACT_THREADS = 1024;
constexpr int LIST_ITEMS = 4;  // block maxima (or counts) a thread takes per step of a scan
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
// t - margin, or FEW_ROWS_CUTOFF when t is -inf.
__global__ void __launch_bounds__(CUT_THREADS)
    int4_cutoff_kernel(const float* __restrict__ sims, long long n_pad,
                       const long long* __restrict__ bids, int kb, const float* __restrict__ extra,
                       int n_extra, const float* __restrict__ margin, int k_cut,
                       float* __restrict__ tops, float* __restrict__ cutoff) {
  __shared__ RadixShared sh;
  __shared__ ScanShared ss;
  constexpr int NT = CUT_THREADS;
  const int q = blockIdx.x;
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

// Grid (ceil(nb / 256), qn): warp w of block x tests blocks 32 (8x + w) + lane
// against query q's cutoff and counts the sims at or above it in each hit.
__global__ void __launch_bounds__(COUNT_THREADS)
    int4_count_kernel(const float* __restrict__ sims, const float* __restrict__ block_max,
                      long long nb, const float* __restrict__ cutoff,
                      unsigned long long* __restrict__ count,
                      unsigned long long* __restrict__ n_blocks) {
  const int q = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long b0 = ((long long)blockIdx.x * (COUNT_THREADS / 32) + (threadIdx.x >> 5)) * 32;
  const float c = cutoff[q];
  const long long b = b0 + lane;
  const bool hit = b < nb && block_max[(long long)q * nb + b] >= c;
  unsigned hits = __ballot_sync(FULL, hit);
  const unsigned nhit = __popc(hits);
  unsigned rows = 0;
  const float4* qs = reinterpret_cast<const float4*>(sims + (long long)q * nb * BLOCK_ROWS);
  while (hits) {
    const int j = __ffs(hits) - 1;
    hits &= hits - 1;
    const float4* p = qs + (b0 + j) * (BLOCK_ROWS / 4);
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(p + lane + 32 * u);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      rows += (v[u].x >= c) + (v[u].y >= c) + (v[u].z >= c) + (v[u].w >= c);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) rows += __shfl_xor_sync(FULL, rows, off);
  if (lane == 0) {
    if (rows) atomicAdd(count + q, (unsigned long long)rows);
    if (nhit) atomicAdd(n_blocks + q, (unsigned long long)nhit);
  }
}

// The extraction's rule for a query: a row is taken when its sim's bits are
// above hi, or equal to hi with its tie key at or above lo. Under the cap hi
// is the cutoff's bits and lo 0 (every row at or above the cutoff); past it
// hi is the cap-th best value's bits and lo the tie key of the last row
// equal to it that still fits.
struct Rule {
  uint32_t hi, pad;
  Key lo;
};

__device__ __forceinline__ bool takes(float v, float bmax, long long row, const Rule& rule) {
  const uint32_t vb = value_bits(v);
  return vb > rule.hi || (vb == rule.hi && semtools::make_key(bmax, row) >= rule.lo);
}

// One block a query: its rule. Past the cap, (1) the ids of the blocks whose
// max is at or above the cutoff, in id order, into listing (at most n_b:
// the host sized n_b from the counts), then (2) the two selects over their
// rows.
__global__ void __launch_bounds__(EXTRACT_THREADS)
    int4_rule_kernel(const float* __restrict__ sims, const float* __restrict__ block_max,
                     long long nb, const float* __restrict__ cutoff,
                     const long long* __restrict__ count, int cap, int n_b,
                     int* __restrict__ listing, Rule* __restrict__ rules) {
  __shared__ RadixShared sh;
  __shared__ ScanShared ss;
  constexpr int NT = EXTRACT_THREADS;
  const int q = blockIdx.x;
  const float c = cutoff[q];
  if (count[q] <= cap) {
    if (threadIdx.x == 0) rules[q] = Rule{value_bits(c), 0u, 0ull};
    return;
  }
  const float* qs = sims + (long long)q * nb * BLOCK_ROWS;
  const float* qm = block_max + (long long)q * nb;
  int* blocks = listing + (long long)q * n_b;
  unsigned listed = 0;
  for (long long s0 = 0; s0 < nb; s0 += (long long)NT * LIST_ITEMS) {
    const long long b = s0 + (long long)threadIdx.x * LIST_ITEMS;
    unsigned flags = 0;
#pragma unroll
    for (int u = 0; u < LIST_ITEMS; ++u)
      if (b + u < nb && qm[b + u] >= c) flags |= 1u << u;
    unsigned total;
    unsigned pos = listed + block_exclusive_scan<NT>(__popc(flags), ss, total);
#pragma unroll
    for (int u = 0; u < LIST_ITEMS; ++u) {
      if ((flags >> u) & 1u) {
        if (pos < (unsigned)n_b) blocks[pos] = (int)(b + u);
        ++pos;
      }
    }
    listed += total;
  }
  const long long rows = (long long)min(listed, (unsigned)n_b) * BLOCK_ROWS;
  __syncthreads();  // the listing is visible to the whole block

  const uint32_t hi = static_cast<uint32_t>(
      kth_largest<NT>(
          [&](auto f) {
            for (long long i = threadIdx.x; i < rows; i += NT) {
              const long long r = ((long long)blocks[i >> BLOCK_SHIFT] << BLOCK_SHIFT) + (i & (BLOCK_ROWS - 1));
              f(static_cast<Key>(value_bits(qs[r])) << 32);
            }
          },
          (unsigned)cap, 32, sh) >> 32);
  const unsigned need = (unsigned)cap - sh.above;
  const Key lo = kth_largest<NT>(
      [&](auto f) {
        for (long long i = threadIdx.x; i < rows; i += NT) {
          const long long blk = blocks[i >> BLOCK_SHIFT];
          const long long r = (blk << BLOCK_SHIFT) + (i & (BLOCK_ROWS - 1));
          if (value_bits(qs[r]) == hi) f(semtools::make_key(qm[blk], r));
        }
      },
      need, 0, sh);
  if (threadIdx.x == 0) rules[q] = Rule{hi, 0u, lo};
}

// Grid (ceil(nb / 256), qn), as int4_count_kernel: each block's count of
// the rows its query's rule takes (0 for a block whose max is below the
// cutoff, which holds none), into counts [qn, nb].
__global__ void __launch_bounds__(COUNT_THREADS)
    int4_block_counts_kernel(const float* __restrict__ sims, const float* __restrict__ block_max,
                             long long nb, const float* __restrict__ cutoff,
                             const Rule* __restrict__ rules, int* __restrict__ counts) {
  const int q = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long b0 = ((long long)blockIdx.x * (COUNT_THREADS / 32) + (threadIdx.x >> 5)) * 32;
  const long long b = b0 + lane;
  const Rule rule = rules[q];
  const float bm = b < nb ? block_max[(long long)q * nb + b] : -CUDART_INF_F;
  const bool hit = b < nb && bm >= cutoff[q];
  unsigned hits = __ballot_sync(FULL, hit);
  int* qc = counts + (long long)q * nb;
  if (b < nb && !hit) qc[b] = 0;
  const float4* qs = reinterpret_cast<const float4*>(sims + (long long)q * nb * BLOCK_ROWS);
  while (hits) {
    const int j = __ffs(hits) - 1;
    hits &= hits - 1;
    const float bmj = __shfl_sync(FULL, bm, j);
    const long long blk = b0 + j;
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(qs + blk * (BLOCK_ROWS / 4) + lane + 32 * u);
    unsigned n = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long r = blk * BLOCK_ROWS + (lane + 32 * u) * 4;
      n += takes(v[u].x, bmj, r, rule) + takes(v[u].y, bmj, r + 1, rule) +
           takes(v[u].z, bmj, r + 2, rule) + takes(v[u].w, bmj, r + 3, rule);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(FULL, n, off);
    if (lane == 0) qc[blk] = (int)n;
  }
}

// One block a query: counts [qn, nb] become their exclusive prefix sums in
// block-id order (each block's first output slot), and out [q, total:cap]
// the sentinel n_pad.
__global__ void __launch_bounds__(EXTRACT_THREADS)
    int4_offsets_kernel(int* __restrict__ counts, long long nb, int cap,
                        long long* __restrict__ out) {
  __shared__ ScanShared ss;
  constexpr int NT = EXTRACT_THREADS;
  const int q = blockIdx.x;
  int* qc = counts + (long long)q * nb;
  unsigned running = 0;
  for (long long s0 = 0; s0 < nb; s0 += (long long)NT * LIST_ITEMS) {
    const long long b = s0 + (long long)threadIdx.x * LIST_ITEMS;
    unsigned c[LIST_ITEMS], sum = 0;
#pragma unroll
    for (int u = 0; u < LIST_ITEMS; ++u) {
      c[u] = b + u < nb ? (unsigned)qc[b + u] : 0u;
      sum += c[u];
    }
    unsigned total;
    unsigned pos = running + block_exclusive_scan<NT>(sum, ss, total);
#pragma unroll
    for (int u = 0; u < LIST_ITEMS; ++u) {
      if (b + u < nb) qc[b + u] = (int)pos;
      pos += c[u];
    }
    running += total;
  }
  long long* qo = out + (long long)q * cap;
  for (long long i = (long long)min(running, (unsigned)cap) + threadIdx.x; i < cap; i += NT)
    qo[i] = nb * BLOCK_ROWS;
}

// Grid (ceil(nb / 256), qn), as int4_block_counts_kernel: a warp writes the
// rows its block's rule takes, in row order, from the block's offset on.
__global__ void __launch_bounds__(COUNT_THREADS)
    int4_write_kernel(const float* __restrict__ sims, const float* __restrict__ block_max,
                      long long nb, const float* __restrict__ cutoff,
                      const Rule* __restrict__ rules, const int* __restrict__ offsets, int cap,
                      long long* __restrict__ out) {
  const int q = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const long long b0 = ((long long)blockIdx.x * (COUNT_THREADS / 32) + (threadIdx.x >> 5)) * 32;
  const long long b = b0 + lane;
  const Rule rule = rules[q];
  const float bm = b < nb ? block_max[(long long)q * nb + b] : -CUDART_INF_F;
  unsigned hits = __ballot_sync(FULL, b < nb && bm >= cutoff[q]);
  const float4* qs = reinterpret_cast<const float4*>(sims + (long long)q * nb * BLOCK_ROWS);
  long long* qo = out + (long long)q * cap;
  while (hits) {
    const int j = __ffs(hits) - 1;
    hits &= hits - 1;
    const float bmj = __shfl_sync(FULL, bm, j);
    const long long blk = b0 + j;
    unsigned base = (unsigned)offsets[(long long)q * nb + blk];
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __ldg(qs + blk * (BLOCK_ROWS / 4) + lane + 32 * u);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      // rows r .. r + 3 of lane l in step u: row order is (u, lane, element)
      const long long r = blk * BLOCK_ROWS + (lane + 32 * u) * 4;
      const unsigned f = takes(v[u].x, bmj, r, rule) | takes(v[u].y, bmj, r + 1, rule) << 1 |
                         takes(v[u].z, bmj, r + 2, rule) << 2 |
                         takes(v[u].w, bmj, r + 3, rule) << 3;
      const unsigned n = __popc(f);
      unsigned inc = n;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(FULL, inc, off);
        if (lane >= off) inc += t;
      }
      unsigned pos = base + inc - n;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if ((f >> e) & 1u) {
          if (pos < (unsigned)cap) qo[pos] = r + e;
          ++pos;
        }
      }
      base += __shfl_sync(FULL, inc, 31);
    }
  }
}

inline bool valid_sweep(int qn, long long nb) {
  return qn >= 1 && qn <= 65535 && nb >= 1 && nb * BLOCK_ROWS < (1LL << 32);
}

}  // namespace

extern "C" {

// sims [qn, nb * 512] and block_max [qn, nb] f32 (16-byte aligned, as
// int4_sims_max writes them; block_max may be null without count). The
// cutoff kernel runs when kb + n_extra > 0: its candidates are the sims of
// the blocks bids [qn, kb] int64 and extra [qn, n_extra] f32; it writes
// tops [qn, k_cut] when tops is not null and cutoff [qn] when margin (one
// f32 on the card) is not null. The count kernel runs when count is not
// null: count and n_blocks [qn] int64 against cutoff [qn] (this launch's or
// the caller's), zeroed first.
int semtools_int4_cutoff_counts(const float* sims, const float* block_max, int qn, long long nb,
                                const long long* bids, int kb, const float* extra, int n_extra,
                                const float* margin, int k_cut, float* tops, float* cutoff,
                                long long* count, long long* n_blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (qn < 1 || qn > 65535 || kb < 0 || n_extra < 0 ||
      (cutoff == nullptr && (margin != nullptr || count != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kb + n_extra > 0) {
    if (k_cut < 1 || (tops == nullptr && margin == nullptr) || (kb > 0 && (bids == nullptr ||
        !valid_sweep(qn, nb) || kb > nb)) || (n_extra > 0 && extra == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    int4_cutoff_kernel<<<qn, CUT_THREADS, 0, st>>>(sims, nb * BLOCK_ROWS, bids, kb, extra, n_extra,
                                                   margin, k_cut, tops, cutoff);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (count != nullptr) {
    if (n_blocks == nullptr || block_max == nullptr || !valid_sweep(qn, nb))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaMemsetAsync(count, 0, sizeof(long long) * qn, st);
    if (err == cudaSuccess) err = cudaMemsetAsync(n_blocks, 0, sizeof(long long) * qn, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long per_block = 32LL * (COUNT_THREADS / 32);
    int4_count_kernel<<<dim3((unsigned)((nb + per_block - 1) / per_block), qn), COUNT_THREADS, 0,
                        st>>>(sims, block_max, nb, cutoff,
                              reinterpret_cast<unsigned long long*>(count),
                              reinterpret_cast<unsigned long long*>(n_blocks));
  }
  return static_cast<int>(cudaGetLastError());
}

// sims [qn, nb * 512], block_max [qn, nb], cutoff [qn] f32; count [qn] int64
// (int4_cutoff_counts'); n_b >= every query's count of blocks at or above
// its cutoff; scratch: 4 + nb + n_b int32 a query (16-byte aligned); out
// [qn, cap] int64. Four launches: the rules, the per-block counts, their
// offsets (and the sentinel tail), the rows.
int semtools_int4_extract_above(const float* sims, const float* block_max, int qn, long long nb,
                                const float* cutoff, const long long* count, int cap, int n_b,
                                int* scratch, long long* out, void* stream) {
  if (!valid_sweep(qn, nb) || cap < 1 || n_b < 1 || n_b > nb || sims == nullptr ||
      block_max == nullptr || cutoff == nullptr || count == nullptr || scratch == nullptr ||
      out == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Rule* rules = reinterpret_cast<Rule*>(scratch);
  int* counts = scratch + 4LL * qn;
  int* listing = counts + (long long)qn * nb;
  const long long per_block = 32LL * (COUNT_THREADS / 32);
  const dim3 grid((unsigned)((nb + per_block - 1) / per_block), qn);
  int4_rule_kernel<<<qn, EXTRACT_THREADS, 0, st>>>(sims, block_max, nb, cutoff, count, cap, n_b,
                                                   listing, rules);
  int4_block_counts_kernel<<<grid, COUNT_THREADS, 0, st>>>(sims, block_max, nb, cutoff, rules,
                                                           counts);
  int4_offsets_kernel<<<qn, EXTRACT_THREADS, 0, st>>>(counts, nb, cap, out);
  int4_write_kernel<<<grid, COUNT_THREADS, 0, st>>>(sims, block_max, nb, cutoff, rules, counts,
                                                    cap, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
