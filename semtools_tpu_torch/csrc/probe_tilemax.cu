// The tile-max probe for Hopper (sm_90a): one templated kernel for the JAX
// package's phase-1 probes, each a Pallas kernel that streams a corpus and
// reduces q . e per tile:
//
//   bf16 plain, int8 convert_bf16 / int_dot   bench_kernel_variants.py
//                                             sweep_kernel (:32)
//   k_full, k_nomask, k_convsum, k_stream,    bench_int8_phase1.py (:97,
//   k_i8dot, k_f32dot                         :112, :124, :133, :142, :157)
//   split-half nibbles from uint8 bytes       bench_int4_sweep.py
//                                             sweep_kernel (:43)
//   sims_shift, sims_mask, sims_native        scripts/probe_int4_opt.py
//                                             (:48, :63, :157)
//   sims_floor, sims_and, _kern_once          scripts/probe_int4_opt2.py
//                                             (:43, :61, :149)
//
// Output [T, Q, tile / sub_rows] f32, T = ceil(n_rows / tile): each query's
// max of q . e over every sub-tile (rows >= limit read as -inf; sub_rows = 1
// writes every row's sims), or for the column sums [T, Q, 1], each tile's
// sums of columns 0..Q-1. The Pallas kernels' (8, Q) replicated output rows
// are a Mosaic layout workaround and are not carried over.
//
// Instances (the `variant` of the entry point; ops/probes.py VARIANTS):
//   0 bf16 rows, bf16 mma            6 int4 split-half, uint8 bytes (P4)
//   1 int8 rows, convert to bf16     7 int4 split-half, shift unpack
//   2 int8 rows, s8 mma              8 int4 split-half, `& 15` unpack
//   3 int8 rows, tf32 mma            9 int4 split-half, float floor unpack
//   4 int8 column sums via bf16      10 int4 interleaved (native)
//   5 int8 column sums in int32
// Instances 7-9 convert each int4 value to bf16 (I2F, then F2FP) and
// multiply on the bf16 tensor cores, as the TPU probes convert and use the
// matrix unit: their probes measure those unpacks. The f32 dot
// (bench_int8_phase1.py k_f32dot casts both sides to f32 for the matrix
// unit) runs on the TF32 tensor cores. Instances 6 and 10 compute their
// probes' function with no conversion a value (NibbleRows): an I2F issues at
// a quarter of the integer rate (16 a clock an SM), which held them to half
// of their bytes' bound; their nibbles, biased to 0..15, are s8 bytes after
// three integer instructions for 8 values, for the s8 tensor cores. (bf16
// built from the nibbles' bits, 0x4300 | u less 136 by one HFMA2 a pair,
// took 11 instructions for 8 values and ran P4 at 62% of its bound.)
//
// Layout. A block is 4 warps; each warp takes spans of `span` rows (inside
// one sub-tile) grid-stride, in m-tiles of 16 rows: `mma.sync` with corpus
// rows as the m = 16 side and the (at most 8) queries as the n = 8 side.
// Lane (g, t) = (lane / 4, lane % 4) holds rows g and g + 8 of the m-tile
// (the PTX ISA's A and C fragments) and, for the B fragment, query g. It
// loads its rows' 16-byte chunks u * 4 + t (the 4 lanes of a row read 64
// contiguous bytes, the warp 8 rows of them). The reduction dimension is
// summed in any order, so the k slots of each mma step are mapped to the
// dims of the lane's own chunks, A and B alike: no shuffle or shared-memory
// staging is needed, and the query fragments are built once per thread in
// registers for the kernel's life (64 words for the tf32 recipe: a lane's
// 64 dims of its query). The tf32 recipe (m16n8k8) makes each int8 value an
// f32 without a conversion instruction: the byte, biased by 128, is put into
// the low mantissa bits of 2^23 by one byte permute, and one subtraction of
// 2^23 + 128 leaves the value; its 32 mma steps an m-tile go to two
// accumulators, so a dependent chain is 16 deep as in the bf16 recipe. It
// loads one m-tile at a time (8 loads a lane in flight) and is given its own
// register budget (MIN_BLOCKS below). The column sums keep 16 sums a chunk.
//
// Full sims (sub_rows = 1; _kern_once's shape). The wrapper gives a warp 64
// rows (ops/probes.py launch_shape), so the 8,192 rows of the probe are 128
// warps across the card, not 8 spans of 1,024 on 2 SMs. Each lane stores its
// C fragment: the 8 lanes of a query write 32 contiguous bytes, a whole
// sector. (Staging the fragments in shared memory for 16-byte stores was
// slower here and cut ptxas's register budget of the int4 instances.)
//
// Exactness. Integer-valued recipes are exact: every product is an integer
// and every sum stays below 2^24 (at most 256 * 127^2 = 4,129,024 for a dot,
// 32,768 * 127 for a tile's column), so the mma's f32 or s32 accumulation
// and the float atomics add exactly in any order; int8 values (|v| <= 127)
// fit tf32's 10-bit mantissa; the biased nibbles' s32 sums less 8 sum(q) are
// exact. bf16 rows sum in the tensor core's f32 order.
//
// What bounds it on this card: bytes for every recipe on the tensor cores
// (2 * Q = 16 operations a stored value, far below the bf16, s8 and tf32
// ridges of ~295, ~590 and ~148 a byte; the tf32 work over 10M rows is 41
// GFLOP, ~0.08 ms at 495 TFLOP/s against 0.76 ms of bytes). The full sims
// move 1.3 MB, under the launch's own cost: there the bound is the launch
// floor, and the design only spreads the rows so that no SM walks them in
// turn. Loads are plain 16-byte loads, several a thread in flight; TMA and
// wgmma are later work.
//
// Interface: a plain C entry point (bound with ctypes) returning the
// cudaError_t of its launch; the caller allocates the output (-inf filled
// when `atomic` and reducing by max, zero filled for the sums).

#include <cuda_bf16.h>

#include <type_traits>

#include "common.cuh"

namespace semtools {
namespace {

constexpr int PDIM = 256;   // model width of every probe
constexpr int PQ = 8;       // queries: the n side of the mma
constexpr int NWARPS = THREADS / 32;

__device__ __forceinline__ int sbyte(unsigned w, int k) {
  return static_cast<int>(w << (24 - 8 * k)) >> 24;
}
__device__ __forceinline__ int sext4(int v) { return static_cast<int>(static_cast<unsigned>(v) << 28) >> 28; }
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x, the lower half, is `lo`
  return *reinterpret_cast<const unsigned*>(&v);
}
__device__ __forceinline__ unsigned word(const int4 x, int i) {
  return static_cast<unsigned>(i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w);
}

// -- row formats for the bf16 mma -------------------------------------------
// ROW_BYTES: stored bytes a row; CH: chunks a lane holds of a row; WPC:
// bf16x2 words a 16-byte chunk unpacks to (consecutive pairs of them are the
// (a0, a2) words of one mma step); MT: m-tiles loaded at once (64 bytes of
// rows a lane); unpack(x, w): the chunk's words; dim(off, i): the first of
// the two dims of word i of the chunk at byte offset `off` of its row.

struct Bf16Rows {
  static constexpr int ROW_BYTES = 2 * PDIM, WPC = 4, MT = 1;
  static constexpr bool BF16_QUERY = true;
  __device__ static void unpack(const int4 x, unsigned* w) {
    for (int i = 0; i < 4; ++i) w[i] = word(x, i);
  }
  __device__ static int dim(int off, int i) { return off / 2 + 2 * i; }
};

struct Int8Rows {
  static constexpr int ROW_BYTES = PDIM, WPC = 8, MT = 2;
  static constexpr bool BF16_QUERY = false;
  __device__ static void unpack(const int4 x, unsigned* w) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned v = word(x, i);
      w[2 * i] = bf16x2(sbyte(v, 0), sbyte(v, 1));
      w[2 * i + 1] = bf16x2(sbyte(v, 2), sbyte(v, 3));
    }
  }
  __device__ static int dim(int off, int i) { return off + 2 * i; }
};

// Nibble unpacks of one byte (k of word v) -> (lo, hi) values.
enum Nibbles { S8_SHIFT, S8_AND, S8_FLOOR };

template <int NIB>
__device__ __forceinline__ void nibbles(unsigned v, int k, float& lo, float& hi) {
  if constexpr (NIB == S8_SHIFT) {  // sims_shift on a signed byte
    const int b = sbyte(v, k);
    lo = static_cast<float>(sext4(b));
    hi = static_cast<float>(b >> 4);
  } else if constexpr (NIB == S8_AND) {  // sims_mask and sims_and: p & 15, p >> 4
    const int b = sbyte(v, k);
    lo = static_cast<float>(b & 15);
    hi = static_cast<float>(b >> 4);
  } else {  // sims_floor: float arithmetic, hi = floor(f / 16), u = f - 16 hi
    const float f = static_cast<float>(sbyte(v, k));
    hi = floorf(f * 0.0625f);
    lo = f - 16.0f * hi;
  }
}

// Split halves: byte j of a row holds dim j (low nibble) and dim 128 + j.
template <int NIB>
struct SplitRows {
  static constexpr int ROW_BYTES = PDIM / 2, WPC = 16, MT = 4;
  static constexpr bool BF16_QUERY = false;
  __device__ static void unpack(const int4 x, unsigned* w) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned v = word(x, i);
      float lo[4], hi[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) nibbles<NIB>(v, k, lo[k], hi[k]);
      w[2 * i] = bf16x2(lo[0], lo[1]);
      w[2 * i + 1] = bf16x2(lo[2], lo[3]);
      w[8 + 2 * i] = bf16x2(hi[0], hi[1]);
      w[8 + 2 * i + 1] = bf16x2(hi[2], hi[3]);
    }
  }
  __device__ static int dim(int off, int i) { return i < 8 ? off + 2 * i : PDIM / 2 + off + 2 * (i - 8); }
};

// Packed int4 rows as s8 bytes for the s8 mma, with no conversion
// (variants 6 and 10). A two's complement nibble n (-8..7) with its top bit
// flipped is u = n + 8 (0..15): (v & 0x0F0F0F0F) ^ 0x08080808 makes the low
// nibbles of word v four s8 bytes u (one lop3), ((v >> 4) & 0x0F0F0F0F) ^
// 0x08080808 the high ones (one shift and one lop3): 3 integer instructions
// for 8 values. The dot of u is q . n + 8 sum(q); the kernel takes 8 sum(q)
// off the int32 sum, exactly. Word 2i + h of a chunk holds the nibbles h
// (0 low, 1 high) of the chunk's word i: byte b of it is nibble h of byte
// off + 4i + b of the row, and dim() says which dim that is.
//   SPLIT        P4's uint8 bytes: byte j holds dim j (low nibble) and
//                dim 128 + j (bench_int4_sweep: (p << 28) >> 28, (p << 24) >> 28)
//   INTERLEAVED  native int4: byte j holds dims 2j (low nibble) and 2j + 1
enum Layout { SPLIT, INTERLEAVED };

template <int L>
struct NibbleRows {
  static constexpr int ROW_BYTES = PDIM / 2, WPC = 8, MT = 4;  // WPC: s8 words a chunk
  __device__ static void unpack(const int4 x, unsigned* w) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned v = word(x, i);
      w[2 * i] = (v & 0x0F0F0F0Fu) ^ 0x08080808u;
      w[2 * i + 1] = ((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
    }
  }
  // the dim of byte b of word i of the chunk at byte offset `off`
  __device__ static int dim(int off, int i, int b) {
    const int byte = off + 4 * (i / 2) + b, h = i % 2;
    return L == INTERLEAVED ? 2 * byte + h : h * (PDIM / 2) + byte;
  }
};

// What reduces the rows: the bf16 mma (the bf16 formats above), the s8 mma
// of int8 rows or of biased nibbles (NibbleRows), the tf32 mma, or (no dot)
// column sums through bf16 or in int32; DOT_S8 and the last three take int8
// rows.
enum Dot { DOT_BF16, DOT_S8, DOT_S8_BIASED, DOT_TF32, SUM_BF16, SUM_INT };

__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                       unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte k of `biased` (int8 bytes XOR 0x80, so byte k holds v + 128) as the
// f32 (and tf32) value v: 2^23 + v + 128 is the float 0x4B0000xx, made by
// one byte permute; one subtraction, exact, leaves v.
__device__ __forceinline__ unsigned tf32_of(unsigned biased, int k) {
  const unsigned bits = __byte_perm(biased, 0x4B000000u, 0x7440u | k);
  return __float_as_uint(__uint_as_float(bits) - 8388736.0f);
}

// Float max through integer atomics: non-negative floats order as ints,
// negative ones (sign bit set, -0 included) inversely as unsigned.
__device__ __forceinline__ void atomic_max_f(float* p, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

struct Args {
  const void* q;
  const int8_t* e;
  int qn;
  long long n_rows, limit, tile, sub_rows, span, total_spans;
  bool atomic;
  int flag;  // always 0: guards a store that keeps every column sum live
  float* out;
};

// Rows r0 + g + 8h of MT m-tiles from r0: the lane's chunks, zero past limit.
template <int ROW_BYTES, int MT>
__device__ __forceinline__ void load_rows(const Args& a, long long r0, int g, int t,
                                          int4 (&x)[MT][2][ROW_BYTES / 64]) {
  constexpr int CH = ROW_BYTES / 64;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = r0 + 16 * m + g + 8 * h;
      const int4* src = reinterpret_cast<const int4*>(a.e + row * ROW_BYTES) + t;
#pragma unroll
      for (int u = 0; u < CH; ++u)
        x[m][h][u] = row < a.limit ? __ldg(src + 4 * u) : make_int4(0, 0, 0, 0);
    }
  }
}

// One m-tile's C fragment (rows rb + g, rb + g + 8; queries 2t, 2t + 1):
// rows at or past the limit read as -inf; written out (sub_rows = 1) or
// folded into the lane's running maxima m.
__device__ __forceinline__ void epilogue(const Args& a, const float (&c)[4], long long rb, int g,
                                         int t, float (&m)[2]) {
  const long long ra = rb + g, rc = ra + 8;
  const float ninf = -CUDART_INF_F;
  const float v0 = ra < a.limit ? c[0] : ninf, v1 = ra < a.limit ? c[1] : ninf;
  const float v2 = rc < a.limit ? c[2] : ninf, v3 = rc < a.limit ? c[3] : ninf;
  if (a.sub_rows == 1) {
    const long long ti = ra / a.tile, r = ra % a.tile;  // rc lies in the same tile
    const int q0 = 2 * t, q1 = q0 + 1;
    float* o = a.out + ti * a.qn * a.tile + r;
    if (q0 < a.qn) {
      o[q0 * a.tile] = v0;
      o[q0 * a.tile + 8] = v2;
    }
    if (q1 < a.qn) {
      o[q1 * a.tile] = v1;
      o[q1 * a.tile + 8] = v3;
    }
  } else {
    m[0] = fmaxf(m[0], fmaxf(v0, v2));
    m[1] = fmaxf(m[1], fmaxf(v1, v3));
  }
}

// The span's maxima (queries 2t, 2t + 1) across the 8 row lanes, stored or
// folded into the output by lane (0, t).
__device__ __forceinline__ void finish_max(const Args& a, long long row0, int g, int t,
                                           float (&m)[2]) {
  if (a.sub_rows == 1) return;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) m[k] = fmaxf(m[k], __shfl_xor_sync(FULL, m[k], off));
  }
  if (g != 0) return;
  const long long s = a.tile / a.sub_rows;
  const long long ti = row0 / a.tile, si = (row0 % a.tile) / a.sub_rows;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int q = 2 * t + k;
    if (q >= a.qn) continue;
    float* p = a.out + (ti * a.qn + q) * s + si;
    if (a.atomic)
      atomic_max_f(p, m[k]);
    else
      *p = m[k];
  }
}

template <class Fmt>
__device__ __forceinline__ float query_value(const Args& a, int g, int d) {
  if (g >= a.qn) return 0.0f;
  if constexpr (Fmt::BF16_QUERY)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[g * PDIM + d]);
  else
    return static_cast<float>(static_cast<const int8_t*>(a.q)[g * PDIM + d]);
}

// Blocks an SM must hold (__launch_bounds__), which sets ptxas's register
// budget: 1 for the tf32 recipe, whose 64 query words and loads in flight
// want ~154 registers (held to ptxas's default budget, 132, it held its
// loads back: 1.48 ms at 10M rows on an H100 80GB HBM3 at 700 W, against
// 0.86); 0, ptxas's default, for every other instance.
template <int D>
constexpr int MIN_BLOCKS = D == DOT_TF32 ? 1 : 0;

template <class Fmt, int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<D>) probe_tilemax_kernel(const Args a) {
  constexpr bool FMT = D == DOT_BF16 || D == DOT_S8_BIASED;  // rows in Fmt's format
  constexpr int RB = FMT ? Fmt::ROW_BYTES : PDIM;
  constexpr int CH = RB / 64;
  constexpr int MT = FMT ? Fmt::MT : D == DOT_TF32 ? 1 : 2;  // m-tiles a load group
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;

  // the B fragments (query g at the dims of the lane's chunks), for life
  constexpr int QW = FMT ? CH * Fmt::WPC : D == DOT_S8 ? CH * 4 : D == DOT_TF32 ? CH * 16 : 1;
  unsigned qw[QW];
  int bias[2] = {0, 0};  // DOT_S8_BIASED: 8 sum(q) of queries 2t, 2t + 1
  if constexpr (D == DOT_BF16) {
#pragma unroll
    for (int u = 0; u < CH; ++u) {
#pragma unroll
      for (int i = 0; i < Fmt::WPC; ++i) {
        const int d = Fmt::dim((4 * u + t) * 16, i);
        qw[u * Fmt::WPC + i] = bf16x2(query_value<Fmt>(a, g, d), query_value<Fmt>(a, g, d + 1));
      }
    }
  } else if constexpr (D == DOT_S8) {
    const int8_t* q8 = static_cast<const int8_t*>(a.q);
#pragma unroll
    for (int u = 0; u < CH; ++u) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qw[u * 4 + i] = g < a.qn ? *reinterpret_cast<const unsigned*>(
                                       q8 + g * PDIM + (4 * u + t) * 16 + 4 * i)
                                 : 0u;
    }
  } else if constexpr (D == DOT_S8_BIASED) {
    const int8_t* q8 = static_cast<const int8_t*>(a.q);
    int sum = 0;  // query g over the lane's dims
#pragma unroll
    for (int u = 0; u < CH; ++u) {
#pragma unroll
      for (int i = 0; i < Fmt::WPC; ++i) {
        unsigned w = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int v = g < a.qn ? q8[g * PDIM + Fmt::dim((4 * u + t) * 16, i, b)] : 0;
          w |= (static_cast<unsigned>(v) & 0xffu) << (8 * b);
          sum += v;
        }
        qw[u * Fmt::WPC + i] = w;
      }
    }
    sum += __shfl_xor_sync(FULL, sum, 1);
    sum += __shfl_xor_sync(FULL, sum, 2);
    bias[0] = 8 * __shfl_sync(FULL, sum, 8 * t);  // lane (2t, 0)
    bias[1] = 8 * __shfl_sync(FULL, sum, 8 * t + 4);
  } else if constexpr (D == DOT_TF32) {  // word u * 16 + j: dim (4u + t) * 16 + j
    const int8_t* q8 = static_cast<const int8_t*>(a.q);
#pragma unroll
    for (int u = 0; u < CH; ++u) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        qw[u * 16 + j] = __float_as_uint(
            g < a.qn ? static_cast<float>(q8[g * PDIM + (4 * u + t) * 16 + j]) : 0.0f);
    }
  }

  using Acc = typename std::conditional<D == SUM_INT, int, float>::type;
  Acc chk = 0;  // every column sum, kept live by the flag-guarded store
  const long long nwarps = static_cast<long long>(gridDim.x) * NWARPS;
  for (long long sp = blockIdx.x * NWARPS + threadIdx.x / 32; sp < a.total_spans; sp += nwarps) {
    const long long row0 = sp * a.span;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    Acc acc[CH][16];
    if constexpr (D == SUM_BF16 || D == SUM_INT) {
#pragma unroll
      for (int u = 0; u < CH; ++u)
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[u][j] = 0;
    }
    for (long long r0 = row0; r0 < row0 + a.span; r0 += 16 * MT) {
      int4 x[MT][2][CH];
      load_rows<RB, MT>(a, r0, g, t, x);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if constexpr (D == DOT_BF16) {
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            unsigned wa[Fmt::WPC], wb[Fmt::WPC];
            Fmt::unpack(x[mt][0][u], wa);
            Fmt::unpack(x[mt][1][u], wb);
#pragma unroll
            for (int j = 0; j < Fmt::WPC / 2; ++j)
              mma_bf16(c, wa[2 * j], wb[2 * j], wa[2 * j + 1], wb[2 * j + 1],
                       qw[u * Fmt::WPC + 2 * j], qw[u * Fmt::WPC + 2 * j + 1]);
          }
        } else if constexpr (D == DOT_S8 || D == DOT_S8_BIASED) {
          int ci[4] = {0, 0, 0, 0};
#pragma unroll
          for (int u = 0; u < CH; ++u) {
            if constexpr (D == DOT_S8) {
              const int4 ra = x[mt][0][u], rb = x[mt][1][u];
              mma_s8(ci, ra.x, rb.x, ra.y, rb.y, qw[u * 4], qw[u * 4 + 1]);
              mma_s8(ci, ra.z, rb.z, ra.w, rb.w, qw[u * 4 + 2], qw[u * 4 + 3]);
            } else {
              unsigned wa[Fmt::WPC], wb[Fmt::WPC];
              Fmt::unpack(x[mt][0][u], wa);
              Fmt::unpack(x[mt][1][u], wb);
#pragma unroll
              for (int j = 0; j < Fmt::WPC / 2; ++j)
                mma_s8(ci, wa[2 * j], wb[2 * j], wa[2 * j + 1], wb[2 * j + 1],
                       qw[u * Fmt::WPC + 2 * j], qw[u * Fmt::WPC + 2 * j + 1]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] = static_cast<float>(ci[i] - bias[i & 1]);
        } else if constexpr (D == DOT_TF32) {
          // step (u, i, h): k slot t is byte 2h of word i of chunk u, slot
          // t + 4 byte 2h + 1; the two accumulators (by h) are summed at the
          // end, exactly
          float c1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int u = 0; u < CH; ++u) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const unsigned va = word(x[mt][0][u], i) ^ 0x80808080u;
              const unsigned vb = word(x[mt][1][u], i) ^ 0x80808080u;
              const int j = u * 16 + 4 * i;
              mma_tf32(c, tf32_of(va, 0), tf32_of(vb, 0), tf32_of(va, 1), tf32_of(vb, 1),
                       qw[j], qw[j + 1]);
              mma_tf32(c1, tf32_of(va, 2), tf32_of(vb, 2), tf32_of(va, 3), tf32_of(vb, 3),
                       qw[j + 2], qw[j + 3]);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) c[i] += c1[i];
        } else {  // column sums of both rows into the lane's 16 columns a chunk
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int u = 0; u < CH; ++u)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const unsigned v = word(x[mt][h][u], i);
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  if constexpr (D == SUM_INT)
                    acc[u][4 * i + k] = __dp4a(static_cast<int>(v), 1 << (8 * k), acc[u][4 * i + k]);
                  else
                    acc[u][4 * i + k] += __bfloat162float(
                        __float2bfloat16_rn(static_cast<float>(sbyte(v, k))));
                }
              }
        }
        if constexpr (D == DOT_BF16 || D == DOT_S8 || D == DOT_S8_BIASED || D == DOT_TF32)
          epilogue(a, c, r0 + 16 * mt, g, t, m);
      }
    }
    if constexpr (D == SUM_BF16 || D == SUM_INT) {
      // the span's sums over the 8 row lanes; lane (0, 0) holds columns 0..15
#pragma unroll
      for (int u = 0; u < CH; ++u)
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) acc[u][j] += __shfl_xor_sync(FULL, acc[u][j], off);
          chk += acc[u][j];
        }
      if (lane == 0) {
        const long long ti = row0 / a.tile;
        for (int q = 0; q < a.qn; ++q) atomicAdd(a.out + ti * a.qn + q, static_cast<float>(acc[0][q]));
      }
    } else {
      finish_max(a, row0, g, t, m);
    }
  }
  if (a.flag) a.out[0] = static_cast<float>(chk);
}

template <class Fmt, int D>
cudaError_t launch(const Args& args, cudaStream_t stream) {
  static LaunchCache cache;
  int grid = 0;
  const cudaError_t err = cache.grid_for(probe_tilemax_kernel<Fmt, D>, 0,
                                         (args.total_spans + NWARPS - 1) / NWARPS, &grid);
  if (err != cudaSuccess) return err;
  probe_tilemax_kernel<Fmt, D><<<grid, THREADS, 0, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace
}  // namespace semtools

extern "C" {

// q [qn <= 8, 256] (bf16 for variant 0, int8 otherwise); e [n_rows, row
// bytes]; rows >= limit (<= n_rows) read as -inf; tile a multiple of 64;
// sub_rows 1 or a multiple of 64 dividing tile; span (a multiple of 64
// dividing sub_rows, or tile for sums and sub_rows = 1) the rows a warp takes
// at a time; out [ceil(n_rows / tile), qn, tile / sub_rows] f32.
int semtools_probe_tilemax(int variant, const void* q, const void* e, int qn, long long n_rows,
                           long long limit, long long tile, long long sub_rows, long long span,
                           int atomic, int flag, float* out, void* stream) {
  using namespace semtools;
  if (qn < 1 || qn > PQ || n_rows < 1 || limit < 0 || limit > n_rows || tile < 64 || tile % 64 ||
      sub_rows < 1 || tile % sub_rows || span < 64 || span % 64 ||
      (sub_rows > 1 && sub_rows % span) || (sub_rows == 1 && tile % span))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long num_tiles = (n_rows + tile - 1) / tile;
  const Args args{q, static_cast<const int8_t*>(e), qn, n_rows, limit, tile, sub_rows, span,
                  num_tiles * tile / span, atomic != 0, flag, out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (variant) {
    case 0: err = launch<Bf16Rows, DOT_BF16>(args, s); break;
    case 1: err = launch<Int8Rows, DOT_BF16>(args, s); break;
    case 2: err = launch<Int8Rows, DOT_S8>(args, s); break;
    case 3: err = launch<Int8Rows, DOT_TF32>(args, s); break;
    case 4: err = launch<Int8Rows, SUM_BF16>(args, s); break;
    case 5: err = launch<Int8Rows, SUM_INT>(args, s); break;
    case 6: err = launch<NibbleRows<SPLIT>, DOT_S8_BIASED>(args, s); break;
    case 7: err = launch<SplitRows<S8_SHIFT>, DOT_BF16>(args, s); break;
    case 8: err = launch<SplitRows<S8_AND>, DOT_BF16>(args, s); break;
    case 9: err = launch<SplitRows<S8_FLOOR>, DOT_BF16>(args, s); break;
    case 10: err = launch<NibbleRows<INTERLEAVED>, DOT_S8_BIASED>(args, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
