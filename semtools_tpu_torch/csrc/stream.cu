// Streaming probes for Hopper (sm_90a): kernels that only read an int8
// [N, 256] corpus and sum its columns, to measure what device memory gives a
// scan on this card. Counterparts of the JAX package's stream sweep
// (benchmarks/quantitative/bench_stream_sweep.py).
//
//   stream_tiles  replaces auto_stream's kernel (:66): one block per whole
//                 tile of `tile` rows, writing the tile's int32 column sums
//                 plus a salt, [N / tile, 256]. Rows past the last whole tile
//                 are not read, as the TPU grid drops them.
//   stream_ring   replaces manual_stream's kernel (:94, its hand DMA ring):
//                 persistent blocks, a few per SM, each walking its share of
//                 `stage_rows`-row stages through a ring of STAGES stages in
//                 shared memory, filled with cp.async.cg 16-byte copies under
//                 commit_group / wait_group; each block adds its int32 column
//                 sums into the [256] output with atomicAdd (exact and
//                 independent of order; the caller puts the salt in first).
//                 The TPU's stages (1-4 MB of VMEM) do not fit in the 227 KB
//                 a block can have, so the sweep points are this card's own.
//
// What bounds them: bytes. A byte costs one integer add (one __dp4a with a
// one-hot selector, which extracts the signed byte and adds it), so the
// corpus read (N * 256 bytes at 3.35 TB/s on the data sheet) is the floor.
// Loads are 16 bytes a thread, neighbouring threads on neighbouring
// addresses: 16 threads cover a 256-byte row and a 128-thread block 8 rows
// a step. Each thread keeps the 16 column sums of its 16 bytes in
// registers; the 8 row groups meet in shared memory at the end. TMA bulk
// copies are later work.
//
// Interface: plain C entry points (bound with ctypes), each returning the
// cudaError_t of its launch. Sums of one column stay far below 2^31.

#include "common.cuh"

namespace semtools {
namespace {

constexpr int SDIM = 256;             // bytes of a row
constexpr int SVECS = SDIM / 16;      // 16-byte vectors of a row
constexpr int SGROUPS = THREADS / SVECS;  // rows a block reads a step

// acc[j] += signed byte j of the 16 bytes v
__device__ __forceinline__ void add_bytes(const int4 v, int (&acc)[16]) {
  const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[4 * i + b] = __dp4a(w[i], 1 << (8 * b), acc[4 * i + b]);
  }
}

// The block's column sums into red (laid out [group][byte][vector] so the
// writes of one warp fall in distinct banks), then column c's total.
__device__ __forceinline__ void stash(const int (&acc)[16], int* red) {
  const int vec = threadIdx.x % SVECS, group = threadIdx.x / SVECS;
#pragma unroll
  for (int j = 0; j < 16; ++j) red[(group * 16 + j) * SVECS + vec] = acc[j];
}

__device__ __forceinline__ int column_total(const int* red, int c) {
  int s = 0;
#pragma unroll
  for (int g = 0; g < SGROUPS; ++g) s += red[(g * 16 + c % 16) * SVECS + c / 16];
  return s;
}

__global__ void __launch_bounds__(THREADS)
    stream_tiles_kernel(const int4* __restrict__ e, long long tile, int salt, int* __restrict__ out) {
  __shared__ int red[SGROUPS * SDIM];
  const int vec = threadIdx.x % SVECS, group = threadIdx.x / SVECS;
  const long long t = blockIdx.x;
  const int4* base = e + t * tile * SVECS + vec;
  int acc[16] = {};
  long long r = group;
  for (; r + 3 * SGROUPS < tile; r += 4 * SGROUPS) {  // four loads in flight a thread
    const int4 v0 = __ldg(base + r * SVECS);
    const int4 v1 = __ldg(base + (r + SGROUPS) * SVECS);
    const int4 v2 = __ldg(base + (r + 2 * SGROUPS) * SVECS);
    const int4 v3 = __ldg(base + (r + 3 * SGROUPS) * SVECS);
    add_bytes(v0, acc);
    add_bytes(v1, acc);
    add_bytes(v2, acc);
    add_bytes(v3, acc);
  }
  for (; r < tile; r += SGROUPS) add_bytes(__ldg(base + r * SVECS), acc);
  stash(acc, red);
  __syncthreads();
  for (int c = threadIdx.x; c < SDIM; c += THREADS)
    out[t * SDIM + c] = salt + column_total(red, c);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int STAGES>
__global__ void __launch_bounds__(THREADS)
    stream_ring_kernel(const int8_t* __restrict__ e, long long n_rows, int stage_rows,
                       int* __restrict__ out) {
  extern __shared__ int4 ring[];
  __shared__ int red[SGROUPS * SDIM];
  const int vec = threadIdx.x % SVECS, group = threadIdx.x / SVECS;
  const long long num_stages = (n_rows + stage_rows - 1) / stage_rows;
  const int stage_vecs = stage_rows * SVECS;
  // this block's stages: blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long mine = (num_stages - blockIdx.x + gridDim.x - 1) / gridDim.x;

  auto rows_of = [&](long long k) {
    const long long row0 = (blockIdx.x + k * gridDim.x) * stage_rows;
    const long long left = n_rows - row0;
    return static_cast<int>(left < stage_rows ? left : stage_rows);
  };
  // Stage k into slot k % STAGES, one commit group (empty past the end, so
  // the group count stays in step with k).
  auto fill_stage = [&](long long k) {
    if (k < mine) {
      const int4* src = reinterpret_cast<const int4*>(
          e + (blockIdx.x + k * gridDim.x) * static_cast<long long>(stage_rows) * SDIM);
      int4* dst = ring + (k % STAGES) * stage_vecs;
      const int vecs = rows_of(k) * SVECS;
      for (int i = threadIdx.x; i < vecs; i += THREADS) cp_async16(dst + i, src + i);
    }
    cp_async_commit();
  };

  for (int k = 0; k < STAGES - 1; ++k) fill_stage(k);
  int acc[16] = {};
  for (long long k = 0; k < mine; ++k) {
    // the slot stage k + STAGES - 1 fills was read in step k - 1, before its
    // closing barrier
    fill_stage(k + STAGES - 1);
    cp_async_wait<STAGES - 1>();  // stage k's group has landed (this thread's copies)
    __syncthreads();              // and every thread's
    const int4* slot = ring + (k % STAGES) * stage_vecs;
    const int rows = rows_of(k);
    for (int r = group; r < rows; r += SGROUPS) add_bytes(slot[r * SVECS + vec], acc);
    __syncthreads();
  }
  cp_async_wait<0>();
  stash(acc, red);
  __syncthreads();
  for (int c = threadIdx.x; c < SDIM; c += THREADS) atomicAdd(out + c, column_total(red, c));
}

template <int STAGES>
cudaError_t launch_ring(const int8_t* e, long long n_rows, int stage_rows, int* out,
                        cudaStream_t stream) {
  static LaunchCache cache;
  const size_t smem = static_cast<size_t>(STAGES) * stage_rows * SDIM;
  cudaError_t err = cache.prepare(stream_ring_kernel<STAGES>, smem);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = cache.grid_for(stream_ring_kernel<STAGES>, smem, (n_rows + stage_rows - 1) / stage_rows,
                       &grid);
  if (err != cudaSuccess) return err;
  stream_ring_kernel<STAGES><<<grid, THREADS, smem, stream>>>(e, n_rows, stage_rows, out);
  return cudaGetLastError();
}

}  // namespace
}  // namespace semtools

extern "C" {

// e [>= num_tiles * tile, 256] int8; out [num_tiles, 256] int32.
int semtools_stream_tiles(const int8_t* e, long long tile, long long num_tiles, int salt, int* out,
                          void* stream) {
  if (tile < 1 || num_tiles < 1 || num_tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  semtools::stream_tiles_kernel<<<static_cast<unsigned>(num_tiles), semtools::THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(e), tile, salt, out);
  return static_cast<int>(cudaGetLastError());
}

// e [>= n_use, 256] int8; out [256] int32, holding the salt: the column
// sums of rows [0, n_use) are added to it.
int semtools_stream_ring(const int8_t* e, long long n_use, int stage_rows, int stages, int* out,
                         void* stream) {
  if (n_use < 1 || stage_rows < 16 || stage_rows % 16) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stages) {
    case 2: return static_cast<int>(semtools::launch_ring<2>(e, n_use, stage_rows, out, s));
    case 3: return static_cast<int>(semtools::launch_ring<3>(e, n_use, stage_rows, out, s));
    case 4: return static_cast<int>(semtools::launch_ring<4>(e, n_use, stage_rows, out, s));
    case 8: return static_cast<int>(semtools::launch_ring<8>(e, n_use, stage_rows, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
