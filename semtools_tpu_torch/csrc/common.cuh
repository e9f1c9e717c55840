// Pieces shared by the scan kernels (fused_scan.cu, int_scan.cuh,
// topk.cuh): block shape, the warp-level exact top-k extraction of the
// single-phase scan, the row keep test and the launch helpers.
//
// Tie rule (exactness, see KERNELS.md "Two-phase kernel"): candidates are
// ordered by (value desc, row index asc) everywhere.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <climits>
#include <cstdint>
#include <mutex>

namespace semtools {

constexpr int ROWS = 128;          // rows per block step = threads per block
constexpr int THREADS = ROWS;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// One warp: the k best of the ROWS values s[0, ROWS) by (value desc,
// position asc), written as (value, base + position). k rounds of
// (max, earliest position, mask out), the rule of the Pallas kernels'
// extract_topk_rounds. Lane l holds positions l, l+32, l+64, l+96.
__device__ inline void warp_topk(const float* s, int k, long long base, float* out_v,
                                 long long* out_i) {
  const int lane = threadIdx.x & 31;
  float v[ROWS / 32];
#pragma unroll
  for (int i = 0; i < ROWS / 32; ++i) v[i] = s[lane + 32 * i];
  unsigned taken = 0;
  for (int r = 0; r < k; ++r) {
    float bv = -CUDART_INF_F;
    int bi = INT_MAX;
#pragma unroll
    for (int i = 0; i < ROWS / 32; ++i) {
      const int p = lane + 32 * i;
      if (!((taken >> i) & 1u) && better(v[i], p, bv, bi)) {
        bv = v[i];
        bi = p;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if ((bi & 31) == lane) taken |= 1u << (bi >> 5);
    if (lane == 0) {
      out_v[r] = bv;
      out_i[r] = base + bi;
    }
  }
}

// Row `row` takes part in a scan: below n_true and, with MASKED, kept by the
// uint8 keep vector.
template <bool MASKED>
__device__ __forceinline__ bool keep(const uint8_t* __restrict__ mask, long long row,
                                     long long n_true) {
  return row < n_true && (!MASKED || mask[row] != 0);
}

// What a launcher asks the driver about its kernel, asked once: the
// dynamic shared memory opted into (above 48 KB it must be) and the blocks
// that fill the card at the last size asked. A launcher holds one as a
// function-local static, one per kernel instance, so a launch costs its
// <<<>>> and a cudaGetLastError. One card per process.
struct LaunchCache {
  std::mutex lock;
  std::atomic<size_t> allowed{0};
  std::atomic<unsigned long long> fill{0};  // smem << 32 | blocks; 0 until asked

  template <typename K>
  cudaError_t prepare(K kernel, size_t smem) {
    if (smem <= allowed.load(std::memory_order_acquire)) return cudaSuccess;
    std::lock_guard<std::mutex> hold(lock);
    if (smem <= allowed.load(std::memory_order_relaxed)) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) allowed.store(smem, std::memory_order_release);
    return err;
  }

  // Enough blocks to fill every SM at the kernel's occupancy, at most `work`.
  template <typename K>
  cudaError_t grid_for(K kernel, size_t smem, long long work, int* grid) {
    unsigned long long f = fill.load(std::memory_order_relaxed);
    if (f == 0 || (f >> 32) != smem) {
      int dev = 0, sms = 0, per_sm = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      f = (static_cast<unsigned long long>(smem) << 32) | static_cast<unsigned>(sms * per_sm);
      fill.store(f, std::memory_order_relaxed);
    }
    const long long cap = static_cast<long long>(f & 0xffffffffull);
    *grid = (int)(work < cap ? work : cap);
    return cudaSuccess;
  }
};

}  // namespace semtools

// Query-count buckets: the per-thread partial sums live in registers, so
// the count is a template argument; queries past qn are zero in shared memory.
#define SEMTOOLS_BY_QUERIES(FN, T, qn, ...)                        \
  ((qn) <= 1    ? FN<T, 1>(__VA_ARGS__)                            \
   : (qn) <= 8  ? FN<T, 8>(__VA_ARGS__)                            \
   : (qn) <= 16 ? FN<T, 16>(__VA_ARGS__)                           \
   : (qn) <= 32 ? FN<T, 32>(__VA_ARGS__)                           \
                : cudaErrorInvalidValue)
