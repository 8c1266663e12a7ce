// Pieces shared by the FCNN kernels that stage operands with cp.async and
// split a contraction over the blocks of a thread-block cluster: the
// forward (fcnn_fwd.cu), dgrad (fcnn_dgrad.cu) and wgrad (fcnn_wgrad.cu)
// kernels, and the copies and chunk maps of the tensor-core forward, dgrad
// and wgrad (fcnn_tc.cuh).  Each operand is float or __nv_bfloat16, read in its own type.
//   * copy_chunk<T, VEC>: one chunk of an operand from device memory into
//     shared memory, or zeros where the source lies outside the operand
//     (the source is then not read): 16 bytes with cp.async where VEC,
//     else 4 bytes: one fp32 element, or a pair of bf16 ones with a 4-byte
//     cp.async where the operand's rows are an even number of elements
//     (the pair is then 4-byte aligned and wholly in or out), and as two
//     guarded plain 2-byte loads where they are odd (cp.async copies 4, 8
//     or 16 aligned bytes);
//   * to_f32 / load4 / store / store4: an element or four neighbouring
//     elements of either type to and from fp32 registers, bf16 rounded to
//     nearest even on the store;
//   * Map: which chunks of an R x W tile a thread copies;
//   * cluster_reduce_rows: the partial tiles of the cluster's blocks
//     summed in rank order through distributed shared memory, rank r
//     taking rows [r·BM/split, (r+1)·BM/split); one launch, no atomics, no
//     workspace, and repeated calls give bit-identical sums.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace fcnn {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy 16 (or 4) bytes, or write zeros when !ok (the source is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// elements of T in one chunk of an operand's row: 16 bytes where VEC, else
// 4 (one fp32 element, two bf16 ones)
template <class T, bool VEC>
constexpr int kChunk = (VEC ? 16 : 4) / static_cast<int>(sizeof(T));

// one chunk (kChunk<T, VEC> elements) whose first element is in range
// where ok, its second (bf16 pairs) where ok_hi; zeros elsewhere.  pairs:
// the operand's rows hold an even number of bf16 elements and its base is
// 4-byte aligned, so a pair is one aligned 4-byte copy.  The plain loads
// of an odd-width bf16 row land in shared memory in program order, before
// the barrier that publishes the stage, like cp.async's
template <class T, bool VEC>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, bool ok, bool ok_hi,
                                           bool pairs) {
  if constexpr (VEC || sizeof(T) == 4) {
    if constexpr (VEC) cp_async16(dst, src, ok);
    else cp_async4(dst, src, ok);
  } else {
    static_assert(sizeof(T) == 2, "float or bf16");
    if (pairs) {
      cp_async4(dst, src, ok);
    } else {
      const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
      uint16_t* d = reinterpret_cast<uint16_t*>(dst);
      d[0] = ok ? s[0] : static_cast<uint16_t>(0);
      d[1] = ok_hi ? s[1] : static_cast<uint16_t>(0);
    }
  }
}

// rows of `width` T elements from `p` take 4-byte bf16 pairs
__host__ __forceinline__ bool pair_rows(const void* p, int width) {
  return width % 2 == 0 && reinterpret_cast<uintptr_t>(p) % 4 == 0;
}

// dgrad and wgrad form dZ = dY * A'(Y) in fp32 from the dY they staged:
// in place over an fp32 dY's slice, into a slice of its own for bf16 dY
template <class TD>
constexpr bool kZInPlace = sizeof(TD) == sizeof(float);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// four neighbouring elements as fp32 (p 16-byte aligned for float, 8-byte
// for bf16); bf16 widens exactly by a shift of its bits
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// one rounding of an fp32 value to the output's type (bf16: to nearest even)
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Which elements of an R x W tile (W elements a row) thread t of THREADS
// copies: chunks of WIDTH elements at (row(t, i), col(t, i)) for i <
// kCount where has(t, i).  Neighbouring threads take neighbouring chunks
// of a row.  Where the tile has fewer chunks than THREADS · kCount (16-byte
// bf16 chunks of a small tile), the last threads copy fewer.
template <int WIDTH, int W, int R, int THREADS>
struct Map {
  static constexpr int kWidth = WIDTH;
  static constexpr int kChunks = R * W / kWidth;
  static constexpr int kCount = (kChunks + THREADS - 1) / THREADS;
  static_assert(kChunks * kWidth == R * W && W % kWidth == 0, "whole chunks per row");
  __device__ static bool has(int t, int i) {
    return kChunks % THREADS == 0 || t + i * THREADS < kChunks;
  }
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
