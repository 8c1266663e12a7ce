// Pieces shared by the FCNN kernels that stage operands with cp.async and
// split a contraction over the blocks of a thread-block cluster: the
// forward (fcnn_fwd.cu), dgrad (fcnn_dgrad.cu) and wgrad (fcnn_wgrad.cu)
// kernels.
//   * cp_async16 / cp_async4: copy 16 or 4 bytes from device memory into
//     shared memory, or write zeros where the source lies outside the
//     operand (src-size 0: the source is not read);
//   * Map: which chunks of an R x W tile a thread copies;
//   * cluster_reduce_rows: the partial tiles of the cluster's blocks
//     summed in rank order through distributed shared memory, rank r
//     taking rows [r·BM/split, (r+1)·BM/split); one launch, no atomics, no
//     workspace, and repeated calls give bit-identical sums.
#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

namespace fcnn {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy 16 (or 4) bytes, or write zeros when !ok (the source is not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// 16-byte copies where VEC, else 4-byte ones
template <bool VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  if constexpr (VEC) cp_async16(dst, src, ok);
  else cp_async4(dst, src, ok);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Which elements of an R x W tile (W floats a row) thread t of THREADS
// copies: kCount chunks of kWidth floats at (row(t, i), col(t, i)), i <
// kCount.  Neighbouring threads take neighbouring chunks of a row.
template <bool VEC, int W, int R, int THREADS>
struct Map {
  static constexpr int kWidth = VEC ? 4 : 1;
  static constexpr int kCount = R * W / kWidth / THREADS;
  static_assert(kCount * kWidth * THREADS == R * W, "whole chunks per thread");
  __device__ static int row(int t, int i) {
    return (t + i * THREADS) / (W / kWidth);
  }
  __device__ static int col(int t, int i) {
    return kWidth * ((t + i * THREADS) % (W / kWidth));
  }
};

// Sum a BM x BC tile over the `split` blocks of the calling cluster.  Each
// block has written its partial tile to `red` (BM rows of PITCH floats in
// its own shared memory).  Rank `rank` sums rows [rank·BM/split,
// (rank+1)·BM/split) over ranks 0, 1, ..., split - 1 in that order and
// hands each sum to epi(row, col, sum).  Every block of the cluster must
// call it; `red` stays untouched until all ranks have read it.
template <int BM, int BC, int PITCH, int THREADS, class Epilogue>
__device__ __forceinline__ void cluster_reduce_rows(float* red, int split,
                                                    int rank, Epilogue epi) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every partial written
  const int rows = BM / split;
  for (int e = threadIdx.x; e < rows * BC; e += THREADS) {
    const int r = rank * rows + e / BC, c = e % BC;
    float sum = 0.f;
    for (int q = 0; q < split; ++q)
      sum += cluster.map_shared_rank(red, q)[r * PITCH + c];
    epi(r, c, sum);
  }
  cluster.sync();  // every partial stays alive until all ranks have read it
}

}  // namespace fcnn
