// What the SSD intra-chunk kernel (ssd_scan.cu) and its backward
// (ssd_scan_bwd.cu) share: the shape limits, the strides they read x, dt_a,
// B and C through, the warp's cumsum of dt_a over a chunk, and the bf16
// kernels' staging of 64-column tiles into 128-byte-swizzled shared memory
// by cp.async, with the bf16 hi/lo split of an fp32 operand.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tc.cuh"

namespace ssd {

constexpr int kMaxQ = 128;
constexpr int kMaxP = 64;    // P: one 64-column tile
constexpr int kMaxN = 128;   // N: one or two 64-column tiles, a template
                             // parameter of the kernels (never a run-time
                             // trip count around a wgmma)

struct Strides4 {
  long long c, q, h;  // chunk, row, head strides in elements; last is 1
};

__host__ __device__ __forceinline__ int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// cs[t] = Σ_{k<=t} a[k·stride] for t < Q <= 128, by one whole warp: each
// lane sums a run of up to 4 consecutive rows (loaded together), then the
// runs' totals are scanned
__device__ __forceinline__ void chunk_cumsum(float* cs, const float* __restrict__ a,
                                             long long stride, int Q) {
  const int lane = threadIdx.x % 32;
  const int per = (Q + 31) / 32;
  const int beg = min(lane * per, Q);
  const int end = min(beg + per, Q);
  float v[kMaxQ / 32];
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) v[k] = beg + k < end ? a[(beg + k) * stride] : 0.f;
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxQ / 32; ++k) {
    run += v[k];
    if (beg + k < end) cs[beg + k] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane > 0)
    for (int t = beg; t < end; ++t) cs[t] += excl;
}

namespace tile {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;               // two warpgroups
constexpr int kRows = 128;                  // rows of a chunk's tile, zero past Q
constexpr int kTileBytes = kRows * 128;     // 128 rows x 64 bf16 columns

// byte offset of the 16-byte chunk j (columns 8j..8j+7) of row r in a
// 128-byte-swizzled tile (the layout TMA's 128-byte swizzle writes)
__device__ __forceinline__ uint32_t sw128(int r, int j) {
  return r * 128 + ((j ^ (r & 7)) << 4);
}

// copy 16 bytes, or write zeros when !ok (the source is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// kRows x 64 columns of one (chunk, head) slice into the swizzled tile at
// byte offset `dst` of `smem`; rows >= n_rows and columns >= n_cols are
// zero.  vec: 16-byte cp.async copies (base and strides 16-byte aligned,
// n_cols a multiple of 8), else element by element.
__device__ __forceinline__ void stage(uint8_t* smem, uint32_t dst,
                                      const bf16* __restrict__ src, long long stride_q,
                                      int n_rows, int n_cols, bool vec) {
  if (vec) {
    const uint32_t base = tc::smem_u32(smem) + dst;
    for (int idx = threadIdx.x; idx < kRows * 8; idx += kThreads) {
      const int r = idx >> 3;
      const int j = idx & 7;
      const bool ok = r < n_rows && 8 * j < n_cols;
      cp_async16(base + sw128(r, j), ok ? src + r * stride_q + 8 * j : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * 64; idx += kThreads) {
      const int r = idx >> 6;
      const int col = idx & 63;
      bf16 v = __float2bfloat16(0.f);
      if (r < n_rows && col < n_cols) v = src[r * stride_q + col];
      *reinterpret_cast<bf16*>(smem + dst + sw128(r, col >> 3) + 2 * (col & 7)) = v;
    }
  }
}

// kNT 64-column tiles of B or C (columns 64t.. of the slice into tile t)
template <int kNT>
__device__ __forceinline__ void stage_n(uint8_t* smem, uint32_t dst,
                                        const bf16* __restrict__ src, long long stride_q,
                                        int n_rows, int n_cols, bool vec) {
#pragma unroll
  for (int t = 0; t < kNT; ++t)
    stage(smem, dst + t * kTileBytes, src + 64 * t, stride_q, n_rows, n_cols - 64 * t,
          vec);
}

// v = hi + lo to ~16 bits: hi = bf16(v), lo = bf16(v − hi)
__device__ __forceinline__ void split(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}

// exp(d) as exp2(d·log2 e): one ex2 on the special-function unit
__device__ __forceinline__ float exp_f(float d) {
  return exp2f(d * 1.4426950408889634f);
}

__device__ __forceinline__ uint32_t pack(bf16 lo_col, bf16 hi_col) {
  const __nv_bfloat162 v = __halves2bfloat162(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace tile
}  // namespace ssd
